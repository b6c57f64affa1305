"""The port's serving engine (``repro_torch.serve.engine``) against the JAX
package's (``repro.serve.engine``), on the CPU.

Greedy tokens must be equal, so the test first requires that no step comes
near a tie: the port's top-2 logit margin is above 1e-3 at every step for the
chosen seed, far above the float32 gap between the packages (about 1e-6). The
cold start from the compressed store must give parameters bit-equal to the
uploaded file, saved the way ``examples/serve_from_compressed.py:48-59`` saves
JAX bf16 parameters.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as japi
from repro.serve.engine import RequestBatcher as JaxRequestBatcher
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.models import api
from repro_torch.serve.engine import RequestBatcher, ServeEngine

SEED = 4          # top-2 margin >= 2.0e-3 at every greedy step below
MARGIN = 1e-3
PROMPT_LENS = [5, 12, 9, 3, 7]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine recording its top-2 margins, margins)."""
    jcfg = _fp32(jax_get_config("qwen2-7b", smoke=True))
    tcfg = _fp32(get_config("qwen2-7b", smoke=True))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(SEED))
    eng = ServeEngine(tcfg, api.params_from_reference({k: np.asarray(v) for k, v in jp.items()},
                                                      "cpu"), device="cpu")
    margins = []

    def recorded(fn):
        def call(*args):
            logits, cache = fn(*args)
            top = logits.topk(2, dim=-1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))
            return logits, cache
        return call

    eng.model.prefill = recorded(eng.model.prefill)
    eng.model.decode_step = recorded(eng.model.decode_step)
    return JaxServeEngine(jcfg, jp), eng, margins


def test_generate_matches_jax_engine(engines):
    jeng, eng, margins = engines
    prompts = np.random.default_rng(SEED).integers(1, eng.cfg.vocab, (3, 12)).astype(np.int32)
    del margins[:]
    got = eng.generate(prompts, 8)
    want = jeng.generate(prompts, 8)
    assert len(margins) == 8 and min(margins) > MARGIN
    assert (got.prompt_len, got.n_new) == (want.prompt_len, want.n_new) == (12, 8)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (3, 20)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_request_batcher_matches_jax_batcher(engines):
    jeng, eng, margins = engines
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, eng.cfg.vocab, n) for n in PROMPT_LENS]
    del margins[:]
    served = {}
    for name, batcher in (("port", RequestBatcher(eng, 2, 6)),
                          ("jax", JaxRequestBatcher(jeng, 2, 6))):
        ids = [batcher.submit(p) for p in prompts]
        done = []
        while len(done) < len(ids):
            done += batcher.run_once()
        assert sorted(done) == ids and batcher.run_once() == []
        served[name] = [batcher.result(i) for i in ids]
    assert min(margins) > MARGIN
    for got, want in zip(served["port"], served["jax"]):
        assert got.shape == (6,)
        np.testing.assert_array_equal(got, want)


def _save_params(params, repo_dir):
    """JAX params as ``params/<name>`` tensors, bf16 as BF16-tagged uint16
    views (examples/serve_from_compressed.py:48-59)."""
    os.makedirs(repo_dir, exist_ok=True)
    tensors, tags = {}, {}
    for k, v in params.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            tensors[f"params/{k}"] = a.view(np.uint16)
            tags[f"params/{k}"] = "BF16"
        else:
            tensors[f"params/{k}"] = a
    st.save_file(tensors, os.path.join(repo_dir, "model.safetensors"), dtype_tags=tags)
    return tensors


def test_from_store_is_bit_exact(tmp_path):
    cfg = get_config("qwen2-7b", smoke=True)
    base = japi.init_params(jax_get_config("qwen2-7b", smoke=True), jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    ft = {k: (np.asarray(v, np.float32) + rng.randn(*v.shape).astype(np.float32) * 5e-3
              ).astype(np.asarray(v).dtype) for k, v in base.items()}
    store = ZLLMStore(str(tmp_path / "store"), backend=TorchBackend(device="cpu"))
    try:
        _save_params(base, str(tmp_path / "org" / "base"))
        want = _save_params(ft, str(tmp_path / "user" / "ft"))
        store.ingest_repo(str(tmp_path / "org" / "base"), "org/base")
        res = store.ingest_file(str(tmp_path / "user" / "ft" / "model.safetensors"), "user/ft",
                                declared_base="org/base")
        assert res.n_bitx > 0  # the fine-tune is stored as a BitX delta
        eng = ServeEngine.from_store(store, "user/ft", "model.safetensors", cfg, device="cpu")
    finally:
        store.close()
    assert eng.params.keys() == {k[len("params/"):] for k in want}
    for name, t in eng.params.items():
        w = want[f"params/{name}"]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape, name
        assert (t.view(torch.int16).numpy() == w.view(np.int16)).all(), name
    out = eng.generate(np.array([[3, 1, 4, 1, 5]], np.int32), 4).tokens
    assert out.shape == (1, 9) and ((0 <= out) & (out < cfg.vocab)).all()


def test_pad_cache_grows_once_and_decode_writes_in_place(engines):
    _, eng, _ = engines
    prompts = np.arange(1, 11, dtype=np.int32).reshape(2, 5)
    logits, cache = eng.model.prefill(eng.params, {"tokens": torch.from_numpy(prompts)})
    grown = eng._pad_cache(cache, 3)
    assert grown["k"].shape[2] == 8 and torch.equal(grown["k"][:, :, :5], cache["k"])
    assert (grown["k"][:, :, 5:] == 0).all()
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    _, after = eng.model.decode_step(eng.params, {"tokens": tok}, grown)
    assert after["k"] is grown["k"] and after["len"] == 6
    assert (grown["k"][:, :, 5] != 0).any() and (grown["k"][:, :, 6:] == 0).all()

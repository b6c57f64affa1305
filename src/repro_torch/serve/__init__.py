"""serve subsystem of the port.

Two servers live here, matching ZipLLM's two serving surfaces:

* ``repro_torch.serve.store_server`` — the async *storage* server: concurrent
  bit-exact file/tensor retrieval and remote writes over the mmap'd zLLM
  store (stdlib asyncio), with the router (``router``: placement, replica
  groups, anti-entropy), the cross-process peer protocol (``peer``) and the
  single-flight decoded cache (``singleflight``). Its stores run on the
  port's ``TorchBackend``, so the BitX and byte-plane kernels launch in the
  server process.
* ``repro_torch.serve.engine`` — the *model* serving engine: batched
  prefill/decode with cold-start loading straight from the compressed store.

Submodules are intentionally not re-exported here, so importing the storage
server never loads the model stack.
"""

# Port copy of src/repro/core/clustering.py: host-only, logic unchanged.
"""LLM family clustering via bit distance (paper §3.4.3, §4.2, Fig. 4).

``FamilyRegistry`` holds the standalone-coded base models; fine-tuned uploads
are matched by (1) shape-signature prefilter — different tensor shapes ⇒
cross-family immediately — then (2) sampled bit distance against the (few)
remaining candidates, thresholded at 4 bits/element (93.5% accuracy, paper
A.0.1). ``cluster_models`` builds the Fig.-4 similarity graph and returns its
connected components.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bitdistance import (DEFAULT_THRESHOLD, bit_distance_arrays,
                                    hamming_total_arrays, shape_signature)
from repro_torch.formats.safetensors import SafetensorsFile

__all__ = ["FamilyRegistry", "cluster_models", "pairwise_bit_distances",
           "score_family_clustering"]


def _sampled_distance(fa: SafetensorsFile, fb: SafetensorsFile,
                      sample_elems: int = 65536) -> float:
    total_bits = 0
    total_elems = 0
    for ta, tb in zip(fa.infos, fb.infos):
        va = fa.tensor(ta.name).reshape(-1)
        vb = fb.tensor(tb.name).reshape(-1)
        if sample_elems and va.size > sample_elems:
            va, vb = va[:sample_elems], vb[:sample_elems]
        total_bits += hamming_total_arrays(va, vb)
        total_elems += va.size
    return total_bits / max(total_elems, 1)


@dataclass
class FamilyRegistry:
    """Registered base models, keyed by shape signature for the prefilter."""

    threshold: float = DEFAULT_THRESHOLD
    sample_elems: int = 65536
    by_sig: Dict[Tuple, List[Tuple[str, str]]] = field(default_factory=dict)  # sig -> [(base_id, path)]
    comparisons: int = 0

    def register(self, base_id: str, path: str) -> None:
        with SafetensorsFile(path) as sf:
            sig = shape_signature(sf.infos)
        self.by_sig.setdefault(sig, []).append((base_id, path))

    def unregister(self, base_id: str) -> int:
        """Remove every registration for ``base_id`` (repo deletion). Returns
        the number of entries dropped; empty signature buckets are pruned."""
        dropped = 0
        for sig in list(self.by_sig):
            kept = [(bid, p) for bid, p in self.by_sig[sig] if bid != base_id]
            dropped += len(self.by_sig[sig]) - len(kept)
            if kept:
                self.by_sig[sig] = kept
            else:
                del self.by_sig[sig]
        return dropped

    def candidates(self, path: str) -> List[Tuple[str, str]]:
        with SafetensorsFile(path) as sf:
            sig = shape_signature(sf.infos)
        return self.by_sig.get(sig, [])

    def match(self, path: str) -> Optional[Tuple[str, float]]:
        """Closest registered base under the threshold, or None."""
        cands = self.candidates(path)
        if not cands:
            return None
        best: Optional[Tuple[str, float]] = None
        with SafetensorsFile(path) as sf:
            for base_id, base_path in cands:
                with SafetensorsFile(base_path) as bf:
                    d = _sampled_distance(sf, bf, self.sample_elems)
                self.comparisons += 1
                if best is None or d < best[1]:
                    best = (base_id, d)
        if best is not None and best[1] <= self.threshold:
            return best
        return None


def pairwise_bit_distances(paths: Sequence[str], sample_elems: int = 65536) -> np.ndarray:
    """Dense pairwise distance matrix (inf for shape-incompatible pairs)."""
    n = len(paths)
    D = np.full((n, n), np.inf)
    np.fill_diagonal(D, 0.0)
    sigs = []
    for p in paths:
        with SafetensorsFile(p) as sf:
            sigs.append(shape_signature(sf.infos))
    for i in range(n):
        for j in range(i + 1, n):
            if sigs[i] != sigs[j]:
                continue
            with SafetensorsFile(paths[i]) as fa, SafetensorsFile(paths[j]) as fb:
                D[i, j] = D[j, i] = _sampled_distance(fa, fb, sample_elems)
    return D


def cluster_models(paths: Sequence[str], threshold: float = DEFAULT_THRESHOLD,
                   sample_elems: int = 65536) -> List[List[int]]:
    """Connected components of the bit-distance similarity graph (Fig. 4)."""
    D = pairwise_bit_distances(paths, sample_elems)
    n = len(paths)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            if D[i, j] <= threshold:
                parent[find(i)] = find(j)
    comps: Dict[int, List[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return sorted(comps.values(), key=len, reverse=True)


def score_family_clustering(paths: Sequence[str], true_labels: Sequence[str],
                            threshold: float = DEFAULT_THRESHOLD,
                            sample_elems: int = 65536) -> Dict[str, float]:
    """Score :func:`cluster_models` against ground-truth family labels.

    Pairwise counting — the standard external clustering measure: every
    unordered model pair is a trial; a true positive is a same-family pair
    the clustering put in one component. Returns precision / recall / F1 /
    Rand-accuracy over all pairs, plus the trial counts. This is what turns
    the paper's "93.5% clustering accuracy" (§A.0.1) claim into a scored,
    CI-gated bench metric (``zllm.cluster.family_f1``) on the synthetic
    hub's emitted ground truth (``families.json``).
    """
    if len(paths) != len(true_labels):
        raise ValueError(f"{len(paths)} paths but {len(true_labels)} labels")
    clusters = cluster_models(paths, threshold, sample_elems)
    pred = [0] * len(paths)
    for ci, comp in enumerate(clusters):
        for i in comp:
            pred[i] = ci
    tp = fp = fn = tn = 0
    n = len(paths)
    for i in range(n):
        for j in range(i + 1, n):
            same_true = true_labels[i] == true_labels[j]
            same_pred = pred[i] == pred[j]
            if same_true and same_pred:
                tp += 1
            elif same_pred:
                fp += 1
            elif same_true:
                fn += 1
            else:
                tn += 1
    n_pairs = tp + fp + fn + tn
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": round(precision, 4), "recall": round(recall, 4),
            "f1": round(f1, 4),
            "accuracy": round((tp + tn) / n_pairs, 4) if n_pairs else 1.0,
            "n_models": n, "n_pairs": n_pairs,
            "n_clusters": len(clusters)}

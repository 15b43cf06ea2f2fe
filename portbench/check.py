"""The comparison that decides ``correct``.

The answers kept from the window (every query of the first pass over the
pool, then a share drawn from the seed) are compared, once the window
has closed and the program's state is freed, with the plain float32
reference run on the same input batches. The number compared:

* ``logit_rel_err``: over every image of every kept answer, the largest
  relative L2 distance between the program's logits and the reference's,
  each centred on its mean over the classes (softmax does not see a
  shift): ``|c(got) - c(ref)| / |c(ref)|``. A non-finite answer reads
  infinity.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import plain

REFERENCE_CHUNK = 32


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per image (row): the centred relative L2 distance."""
    g = got.double()
    r = ref.double()
    g = g - g.mean(dim=1, keepdim=True)
    r = r - r.mean(dim=1, keepdim=True)
    err = (g - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-300)
    return torch.where(torch.isfinite(err), err,
                       torch.full_like(err, float("inf")))


def reference_logits(table, params, pool, indices, blob: str
                     ) -> Dict[int, torch.Tensor]:
    """The reference's logits (on the host) for the pool batches
    ``indices``, computed in blocks of ``REFERENCE_CHUNK`` images."""
    batch = pool.shape[1]
    x = pool[list(indices)].reshape(-1, *pool.shape[2:])
    out = plain.forward_chunked(table, params, x, blob,
                                chunk=REFERENCE_CHUNK).cpu()
    return {j: out[i * batch:(i + 1) * batch] for i, j in enumerate(indices)}


def against_reference(table, params, pool, kept, cfg
                      ) -> Tuple[Dict[str, float], List[float]]:
    """(numbers, each kept answer's worst image)."""
    indices = sorted({j for j, _ in kept})
    ref = reference_logits(table, params, pool, indices, cfg["logits"])
    per_answer = [float(rel_err(got, ref[j]).max()) for j, got in kept]
    return {"logit_rel_err": max(per_answer)}, per_answer


def failed(per_answer: List[float], limits: Dict[str, float]) -> int:
    """Kept answers over the limit."""
    return sum(1 for e in per_answer if not e <= limits["logit_rel_err"])

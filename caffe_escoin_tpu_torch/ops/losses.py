"""Loss and metric ops of inference nets (port of
``caffe_escoin_tpu/ops/losses.py``: ``softmax_cross_entropy`` and
``accuracy``, Caffe's semantics: the softmax loss averages over the valid,
non-ignored examples). The other losses come with the training port."""

from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(logits, labels, *,
                          ignore_label: Optional[int] = None):
    """logits [N, C], integer labels [N] -> scalar mean loss."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if ignore_label is not None:
        valid = (labels != ignore_label).to(logits.dtype)
        return (nll * valid).sum() / valid.sum().clamp(min=1.0)
    return nll.mean()


def accuracy(logits, labels, *, top_k: int = 1,
             ignore_label: Optional[int] = None):
    """Top-k accuracy (accuracy_layer.cpp)."""
    if top_k == 1:
        correct = torch.argmax(logits, dim=-1) == labels
    else:
        topk = torch.topk(logits, top_k, dim=-1).indices
        correct = (topk == labels[:, None]).any(dim=-1)
    correct = correct.float()
    if ignore_label is not None:
        valid = (labels != ignore_label).float()
        return (correct * valid).sum() / valid.sum().clamp(min=1.0)
    return correct.mean()

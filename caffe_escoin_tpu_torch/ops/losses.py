"""Loss and metric ops (port of ``caffe_escoin_tpu/ops/losses.py``).

Reference: `src/caffe/layers/{softmax_loss,sigmoid_cross_entropy_loss,
euclidean_loss,hinge_loss,multinomial_logistic_loss,infogain_loss,
contrastive_loss,accuracy}_layer.cpp`. Caffe's semantics: the softmax loss
averages over the valid (non-ignored) examples, hinge is L1 by default,
euclidean is 1/(2N) * ||a-b||^2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits, labels, *,
                          ignore_label: Optional[int] = None):
    """logits [N, C], integer labels [N] -> scalar mean loss."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if ignore_label is not None:
        valid = (labels != ignore_label).to(logits.dtype)
        return (nll * valid).sum() / valid.sum().clamp(min=1.0)
    return nll.mean()


def sigmoid_cross_entropy(logits, targets):
    """Elementwise sigmoid cross-entropy, summed over the features and
    averaged over the batch (the layer normalizes by the batch size)."""
    per = (logits.clamp(min=0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return per.sum() / logits.shape[0]


def euclidean_loss(a, b):
    d = (a - b).reshape(a.shape[0], -1)
    return 0.5 * (d * d).sum(dim=-1).mean()


def hinge_loss(logits, labels, *, norm: str = "L1"):
    """One-vs-all hinge: the margins 1 + s_j - s_label of the other
    classes, summed (L1) or squared and summed (L2), over the batch."""
    n, c = logits.shape
    one_hot = F.one_hot(labels.long(), c).to(logits.dtype)
    true = (logits * one_hot).sum(dim=-1, keepdim=True)
    margins = (1.0 + logits - true).clamp(min=0.0) * (1.0 - one_hot)
    if norm == "L2":
        return (margins * margins).sum() / n
    return margins.sum() / n


def multinomial_logistic_loss(probs, labels, *, eps=1e-20):
    """-log(p[label]) over already-normalized probabilities
    (softmax_cross_entropy takes logits)."""
    p = torch.gather(probs, -1, labels.long()[:, None])[:, 0]
    return -torch.log(p.clamp(min=eps)).mean()


def infogain_loss(probs, labels, infogain, *, eps=1e-20):
    """-sum_j H[label, j] * log(p_j), averaged over the batch. H [C, C];
    H = I is the multinomial logistic loss."""
    h_rows = infogain[labels.long()]
    return -(h_rows * torch.log(probs.clamp(min=eps))).sum(dim=-1).mean()


def contrastive_loss(a, b, similar, *, margin=1.0, legacy_version=False):
    """Hadsell-Chopra-LeCun contrastive loss:
    L = 1/2N * sum[ y*d^2 + (1-y)*max(margin - d, 0)^2 ] with d = ||a-b||;
    ``legacy_version`` uses max(margin - d^2, 0) (the layer's legacy
    flag)."""
    diff = a - b
    d2 = (diff * diff).sum(dim=-1)
    d = torch.sqrt(d2.clamp(min=1e-12))
    y = similar.to(a.dtype)
    if legacy_version:
        dissim = (margin - d2).clamp(min=0.0)
    else:
        dissim = (margin - d).clamp(min=0.0) ** 2
    return 0.5 * (y * d2 + (1.0 - y) * dissim).mean()


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

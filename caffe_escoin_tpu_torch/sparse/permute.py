"""Sparsity-pattern-aware channel permutation (port of
``caffe_escoin_tpu/sparse/permute.py``, a numpy copy: the port may not
import the JAX package).

The MXU only skips work at block granularity, and a random unstructured
pattern at 90% sparsity has essentially no empty (128,128) blocks
(P(empty) = 0.9^16384 ~ 0). REAL pruned weights are not random — magnitude
pruning kills correlated structures (weak channels, weak offset planes) —
so reordering input/output channels can concentrate the survivors into far
fewer live blocks. This module finds such permutations greedily.

Permutation semantics: for W[K, Cout] with K = (offset, cin) rows,
* a Cout permutation reorders output channels — FREE to deploy when the
  consumer's weights are permuted along cin to match (for conv chains,
  producer cout-perm == consumer cin-perm);
* a cin permutation reorders input channels within every kernel offset —
  free when the producer's cout was permuted identically.
The greedy objective is the number of live (bk, bn) blocks of the permuted
GEMM-view weight, i.e. exactly the XBSP executors' work term.

This is the counterpart of the literature's channel-permutation tricks for
N:M sparsity (and of the reference's column-blocked CSR reordering goal,
`base_conv_layer.cpp:108-231`, which blocked columns for cache locality).
``deploy_unstructured`` takes the port's ``Net`` and tensor params, works
on host copies, and returns tensors on each param's device and dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _live_blocks(mask: np.ndarray, bk: int, bn: int) -> int:
    """Number of (bk, bn) blocks of boolean mask with any nonzero."""
    K, N = mask.shape
    Kp, Np = -(-K // bk) * bk, -(-N // bn) * bn
    m = np.zeros((Kp, Np), bool)
    m[:K, :N] = mask
    return int(
        m.reshape(Kp // bk, bk, Np // bn, bn).any(axis=(1, 3)).sum())


def _greedy_group(sig: np.ndarray, group: int) -> np.ndarray:
    """Greedy grouping of columns by signature union.

    sig: [C, S] bool — per column, which signature bits (row-blocks) are
    live. Returns a permutation of range(C) such that consecutive groups of
    ``group`` columns have (locally) minimal signature-union sizes: seed each
    group with the densest unassigned column, then repeatedly add the column
    whose union increase is smallest.
    """
    C = sig.shape[0]
    unassigned = np.ones(C, bool)
    order = []
    weights = sig.sum(axis=1)
    while unassigned.any():
        cand = np.where(unassigned)[0]
        seed = cand[np.argmax(weights[cand])]
        cur = sig[seed].copy()
        members = [seed]
        unassigned[seed] = False
        while len(members) % group != 0 and unassigned.any():
            cand = np.where(unassigned)[0]
            # union growth if added; tie-break toward denser columns (pack
            # heavy columns together, leaving later groups sparser)
            growth = (~cur & sig[cand]).sum(axis=1)
            pick = cand[np.lexsort((-weights[cand], growth))[0]]
            cur |= sig[pick]
            members.append(pick)
            unassigned[pick] = False
        order.extend(members)
    return np.asarray(order)


def block_permutation(
    wmat: np.ndarray,
    block_shape: Tuple[int, int],
    *,
    kernel_offsets: int = 1,
    passes: int = 2,
    optimize_rows: bool = True,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Find (row_perm_within_cin, col_perm) minimizing live blocks.

    wmat: [K, Cout] GEMM-view weight with K = kernel_offsets * cin rows in
    (offset, cin) order. The row permutation acts on the cin index and is
    replicated across offsets (so it stays deployable as a channel perm);
    the column permutation acts on Cout.

    Returns (cin_perm, cout_perm, stats); apply as
        w2 = wmat.reshape(off, cin, cout)[:, cin_perm][:, :, cout_perm]
    """
    bk, bn = block_shape
    K, N = wmat.shape
    cin = K // kernel_offsets
    mask = wmat != 0
    cin_perm = np.arange(cin)
    cout_perm = np.arange(N)
    before = _live_blocks(mask, bk, bn)

    def apply_perms():
        m = mask.reshape(kernel_offsets, cin, N)[:, cin_perm][:, :, cout_perm]
        return m.reshape(K, N)

    for _ in range(passes):
        m = apply_perms()
        # cout pass: signature = live bk-row-blocks per output channel
        Kp = -(-K // bk) * bk
        mp = np.zeros((Kp, N), bool)
        mp[:K] = m
        sig_c = mp.reshape(Kp // bk, bk, N).any(axis=1).T  # [N, Kp/bk]
        cout_perm = cout_perm[_greedy_group(sig_c, max(1, bn))]
        if not optimize_rows:
            # cout-only mode: deployable by permuting just the consumer's
            # input rows, no upstream propagation needed
            continue
        m = apply_perms()
        # cin pass: signature = live bn-col-blocks per INPUT channel,
        # unioned across kernel offsets (the row perm must be shared)
        Np = -(-N // bn) * bn
        mp = np.zeros((K, Np), bool)
        mp[:, :N] = m
        per_row = mp.reshape(K, Np // bn, bn).any(axis=2)  # [K, Np/bn]
        sig_r = per_row.reshape(kernel_offsets, cin, -1).any(axis=0)
        group_rows = max(1, bk if cin >= bk else cin)
        cin_perm = cin_perm[_greedy_group(sig_r, group_rows)]

    after = _live_blocks(apply_perms(), bk, bn)
    stats = dict(blocks_before=before, blocks_after=after,
                 reduction=round(1.0 - after / max(1, before), 4))
    return cin_perm, cout_perm, stats


def permute_conv_weight(w_hwio: np.ndarray, cin_perm, cout_perm) -> np.ndarray:
    """Apply channel permutations to a conv weight [KH,KW,Cin,Cout]."""
    return np.asarray(w_hwio)[:, :, cin_perm][:, :, :, cout_perm]


# ---------------------------------------------------------------------
# graph-level deployment of an unstructured checkpoint
# ---------------------------------------------------------------------

# layer types that preserve channel identity/order between a producer's
# cout and a downstream consumer's cin (BatchNorm/Scale are per-channel
# and COULD be permuted along, but need their state/params permuted too —
# out of scope for the greedy pass, so chains through them are skipped)
CHANNEL_PRESERVING = {"ReLU", "PReLU", "Dropout", "Pooling", "Split",
                      "Flatten"}
_WEIGHT_TYPES = ("Convolution", "ConvolutionReLU", "EscConvolution",
                 "InnerProduct")


def find_permutable_pairs(net):
    """(producer_layer, consumer_layer) pairs whose channel permutation is
    FREE to deploy: producer conv/fc -> (channel-preserving, single-consumer
    hops) -> consumer conv/fc, both ungrouped.

    Two rules the JAX function lacks, for a net after ``fuse_inference``,
    whose convs add a residual (a second bottom, ``fuse_add``): the blob
    must reach the consumer as its first bottom (the input its cin
    permutation reorders, not the residual), and a producer that adds a
    residual is never permuted (its output carries the residual's channel
    order). On a net without such convs the pairs are the JAX function's."""
    consumers = {}
    for layer in net.layers:
        for b in layer.spec.bottoms:
            consumers.setdefault(b, []).append(layer)
    pairs = []
    for layer in net.layers:
        if layer.spec.type not in _WEIGHT_TYPES:
            continue
        if layer.spec.params.get("group", 1) != 1:
            continue  # per-group perms not supported: skip
        if len(layer.spec.bottoms) > 1:
            continue  # a fused residual add
        blob = layer.spec.tops[0]
        hops = 0
        while hops < 8:
            cons = consumers.get(blob, [])
            if len(cons) != 1:
                break
            nxt = cons[0]
            if nxt.spec.type in _WEIGHT_TYPES:
                if (nxt.spec.params.get("group", 1) == 1
                        and nxt.spec.bottoms[0] == blob):
                    pairs.append((layer, nxt))
                break
            if nxt.spec.type not in CHANNEL_PRESERVING:
                break
            blob = nxt.spec.tops[0]
            hops += 1
    return pairs


def _host(t) -> np.ndarray:
    """A host numpy copy of a tensor on any device (bf16 widened to f32,
    which numpy lacks)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _like(a: np.ndarray, ref):
    """``a`` as a tensor on ``ref``'s device and of its dtype."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ref.device,
                                                             ref.dtype)
    return a


def _apply_cout_perm(p, perm):
    """Permute a producer's output channels (weights last dim + bias)."""
    q = dict(p)
    q["w"] = _like(_host(p["w"])[..., perm], p["w"])
    if "b" in p:
        q["b"] = _like(_host(p["b"])[perm], p["b"])
    return q


def _apply_cin_perm(p, perm, layer, blob_shapes):
    """Permute a consumer's input channels. Conv: weight axis 2. FC fed by
    a 4-D blob: rows are (h, w, c)-flattened — permute the c stratum."""
    q = dict(p)
    w = _host(p["w"])
    if layer.spec.type == "InnerProduct":
        bshape = blob_shapes.get(layer.spec.bottoms[0])
        if bshape is not None and len(bshape) == 4:
            _, h, wd, c = bshape
            k, m = w.shape
            if k != h * wd * c:
                raise ValueError(f"{layer.spec.name}: {k} weight rows for "
                                 f"a bottom of {bshape}")
            w = w.reshape(h, wd, c, m)[:, :, perm].reshape(k, m)
        else:
            w = w[perm]
    else:
        w = w[:, :, perm, :]
    q["w"] = _like(w, p["w"])
    return q


def deploy_unstructured(net, params, *, block_shape=(128, 128),
                        min_density=0.05, layers=None, log=None):
    """Deploy an unstructured-sparse checkpoint on the block-skipping
    executors: greedy channel permutation (cout of each permutable
    producer, propagated for free into its consumer's cin) concentrating
    the survivors into fewer live blocks, then block densification
    (zeroing sub-``min_density`` blocks). Pair with masked fine-tuning to
    recover the densification loss.

    ``layers``: names eligible for permutation/densification (default: all
    weighted layers); consumers outside the set still receive the
    (lossless) cin permutation. Returns (new_params, report) where report
    carries per-layer live-block and extra-zeroed stats. The new params
    are tensors on each old one's device, of its dtype."""
    from caffe_escoin_tpu_torch.sparse.weight_align import gemm_view
    from caffe_escoin_tpu_torch.utils.pruning import densify_blocks

    blob_shapes = getattr(net, "blob_shapes", {})
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    report = {"permuted": [], "densified": [], "block_shape": block_shape,
              "min_density": min_density}
    eligible = set(layers) if layers is not None else {
        l.spec.name for l in net.layers if l.spec.type in _WEIGHT_TYPES}

    for prod, cons in find_permutable_pairs(net):
        pn, cn = prod.spec.name, cons.spec.name
        if pn not in eligible or pn not in out or cn not in out:
            continue
        p = out[pn]
        if not isinstance(p, dict) or "w" not in p:
            continue
        w = _host(p["w"])
        if w.ndim == 4:
            kh, kw = w.shape[:2]
            wmat = gemm_view(w)
            offsets = kh * kw
        else:
            wmat = w
            offsets = 1
        _, cout_perm, stats = block_permutation(
            wmat, block_shape, kernel_offsets=offsets, optimize_rows=False)
        if stats["blocks_after"] >= stats["blocks_before"]:
            continue  # permutation did not help: leave identity
        out[pn] = _apply_cout_perm(p, cout_perm)
        out[cn] = _apply_cin_perm(out[cn], cout_perm, cons, blob_shapes)
        row = dict(layer=pn, consumer=cn, **stats)
        report["permuted"].append(row)
        if log:
            log(f"  permute {pn}->{cn}: live blocks "
                f"{stats['blocks_before']} -> {stats['blocks_after']} "
                f"(-{stats['reduction']:.1%})")

    for layer in net.layers:
        n = layer.spec.name
        if n not in eligible or n not in out:
            continue
        p = out[n]
        if not isinstance(p, dict) or "w" not in p:
            continue
        w = _host(p["w"])
        if w.ndim == 4:
            wmat = gemm_view(w)
            wd, dstats = densify_blocks(wmat, block_shape, min_density)
            wd = wd.reshape(w.shape)
        else:
            wd, dstats = densify_blocks(w, block_shape, min_density)
        out[n] = dict(p, w=_like(wd, p["w"]))
        report["densified"].append(dict(layer=n, **dstats))
        if log:
            log(f"  densify {n}: block density "
                f"{dstats['block_density']:.2f}, "
                f"+{dstats['extra_zeroed_frac']:.1%} zeroed")
    return out, report

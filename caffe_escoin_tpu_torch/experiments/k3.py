"""Every formulation of a block-sparse 3x3 on ResNet-50's k3 shapes (port
of ``scripts/exp_k3_r5.py``): at b32, weights pruned to 90% in 128x128
blocks, bf16 activations, each arm timed by ``device_time`` over
CUDA-graph replays cycling 4 inputs:

* ``unroll``: the XBSP per-block unroll (``kernels/xla_block_sparse.conv``);
* ``gathered_cols``: the XBSP per-column gathered GEMM;
* ``dense_bf16``: ``F.conv2d`` in bf16, channels_last, on the pruned weight;
* ``fused_cuda``: the hand ``sconv_fused`` kernel
  (``kernels/sconv_fused.sconv``), where ``sconv_fused.supported``;
* ``bbox<r>x<c>``: the conv on the live kernel offsets' bounding box, with
  asymmetric padding;
* ``prepad_unroll``: the unroll on an input padded beforehand;
* ``padonly``: that padding alone;
* ``prod_concat_plain`` / ``prod_concat_padded`` / ``prod_single_plain`` /
  ``prod_single_padded``: a producer 1x1 (two block columns concatenated,
  or one) with and without the spatial pad of its output.

Each row carries ``err``, its max abs error against the same function in
f32 on the same inputs (the f32 dense conv of the pruned weight for the
conv arms), and ``ref_max``, the reference's max|.|. An arm that raises
gives an ``error`` row, as the script's did.

    python -m caffe_escoin_tpu_torch.experiments.k3 [--shapes 56,7] \\
        [--platform cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.kernels import sconv_fused
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.benchmark import device_time
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

SHAPES = {  # map -> (cin, cout) for the ResNet-50 k3 family
    56: (64, 64), 28: (128, 128), 14: (256, 256), 7: (512, 512)}
ARMS = "unroll,gcols,dense,fused,bbox,prepad,padonly,padconcat"
ITERS = 12


def conv_nhwc(x, w_hwio, *, stride=(1, 1), pad=((0, 0), (0, 0)),
              lhs_dilation_w: int = 1):
    """NHWC conv through ``F.conv2d`` on channels_last views, with
    asymmetric padding (a negative amount crops) and an optional input
    dilation along W (``lax.conv_general_dilated``'s ``lhs_dilation``)."""
    if lhs_dilation_w > 1:
        n, h, w, c = x.shape
        xd = x.new_zeros((n, h, (w - 1) * lhs_dilation_w + 1, c))
        xd[:, :, ::lhs_dilation_w] = x
        x = xd
    (pt, pb), (pl, pr) = pad
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    out = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.to(x.dtype).permute(3, 2, 0, 1),
                   stride=tuple(stride))
    return out.permute(0, 2, 3, 1)


def live_offsets(aligned, k):
    """The (row, col) kernel offsets that hold a live block, sorted."""
    block_row, bcol_nnz = aligned.bsc.pattern()
    n_cin_b = aligned.cin_pad // aligned.bsc.block_shape[0]
    offs = sorted({int(block_row[j, s]) // n_cin_b
                   for j in range(block_row.shape[0])
                   for s in range(int(bcol_nnz[j]))})
    return [(o // k, o % k) for o in offs], int(bcol_nnz.sum())


def arms_of(hw, device, *, batch, sparsity, arms, rng):
    """[(shape tag, arm, fn, ref_fn, arg_sets, live, offsets)] at map
    ``hw``: every arm's bf16 callable beside its f32 reference."""
    cin, cout = SHAPES[hw]
    n, k, p = batch, 3, 1
    policy = ExecutionPolicy(block_shape=common.BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False)
    xs = [torch.from_numpy(rng.standard_normal((n, hw, hw, cin)).astype(
        np.float32) * 0.1).to(device, torch.bfloat16) for _ in range(4)]
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * .05
    wp = prune_conv_weight(wt, sparsity, common.BLOCK)
    aligned = weight_align(wp, None, policy=policy).to(device, torch.bfloat16)
    w32 = torch.from_numpy(wp).to(device)
    wb = w32.bfloat16()
    sets = [(x,) for x in xs]
    tag = f"{hw}x{hw} {cin}->{cout} k3 b{n}"
    lo_rc, nlive = live_offsets(aligned, k)

    def ref_conv(y):
        return conv_nhwc(y.float(), w32, pad=((p, p), (p, p)))

    out = []

    def add(name, fn, ref, arg_sets=sets):
        out.append((tag, name, fn, ref, arg_sets, nlive, lo_rc))

    if "unroll" in arms:
        add("unroll", lambda y: xbs.conv(y, aligned, padding=(p, p)),
            ref_conv)
    if "gcols" in arms:
        add("gathered_cols", lambda y: xbs.conv_gathered_cols(
            y, aligned, padding=(p, p)), ref_conv)
    if "dense" in arms:
        add("dense_bf16", lambda y: conv_nhwc(y, wb, pad=((p, p), (p, p))),
            ref_conv)
    if "fused" in arms and sconv_fused.supported(xs[0], aligned):
        add("fused_cuda", lambda y: sconv_fused.sconv(
            y, aligned, padding=(p, p), relu=False), ref_conv)
    if "bbox" in arms and lo_rc:
        r0, r1 = min(r for r, _ in lo_rc), max(r for r, _ in lo_rc)
        c0, c1 = min(c for _, c in lo_rc), max(c for _, c in lo_rc)
        wcrop = wb[r0:r1 + 1, c0:c1 + 1]
        pad = ((p - r0, r1 - p), (p - c0, c1 - p))
        add(f"bbox{r1 - r0 + 1}x{c1 - c0 + 1}",
            lambda y: conv_nhwc(y, wcrop, pad=pad), ref_conv)
    if "prepad" in arms:
        xps = [(F.pad(x, (0, 0, p, p, p, p)),) for x in xs]
        add("prepad_unroll", lambda y: xbs.conv(y, aligned, padding=(0, 0)),
            lambda y: conv_nhwc(y.float(), w32), xps)
    if "padonly" in arms:
        def padonly(y):
            return F.pad(y, (0, 0, p, p, p, p))

        add("padonly", padonly, lambda y: padonly(y.float()))
    if "padconcat" in arms:
        # a producer 1x1 with cout = 2 x 128 (two block columns) whose
        # epilogue concatenates: does padding each column cost extra?
        cin2, co_col = 256, 128
        x2 = [(torch.from_numpy(rng.standard_normal(
            (n, hw, hw, cin2)).astype(np.float32) * .1).to(
                device, torch.bfloat16),) for _ in range(4)]
        w2 = [torch.from_numpy(rng.standard_normal((cin2, co_col)).astype(
            np.float32) * .05).to(device, torch.bfloat16) for _ in range(2)]

        def cols_of(y, ws):
            # the product in f32 accumulation, ReLU, then the cast
            return [torch.relu(torch.matmul(y, w).float()).to(y.dtype)
                    for w in ws]

        def pad_each(cols):
            return [F.pad(c, (0, 0, p, p, p, p)) for c in cols]

        def prod_concat_plain(y, ws=w2):
            return torch.cat(cols_of(y, ws), dim=-1)

        def prod_concat_padded(y, ws=w2):
            return torch.cat(pad_each(cols_of(y, ws)), dim=-1)

        def prod_single_plain(y, ws=w2[:1]):
            return cols_of(y, ws)[0]

        def prod_single_padded(y, ws=w2[:1]):
            return pad_each(cols_of(y, ws))[0]

        w2f = [w.float() for w in w2]
        for fn in (prod_concat_plain, prod_concat_padded):
            add(fn.__name__, fn,
                lambda y, fn=fn: fn(y.float(), w2f), x2)
        for fn in (prod_single_plain, prod_single_padded):
            add(fn.__name__, fn,
                lambda y, fn=fn: fn(y.float(), w2f[:1]), x2)
    return out


def run(device, emit, *, hws=(56, 28, 14, 7), batch=32, sparsity=0.9,
        arms=ARMS, iters=ITERS):
    """One row per (shape, arm): ``us``, ``err``, ``ref_max``, the live
    blocks and offsets; an ``error`` row where the arm raised."""
    arms = set(arms.split(",")) if isinstance(arms, str) else set(arms)
    rng = np.random.default_rng(0)
    rows = []
    for hw in hws:
        for tag, name, fn, ref, sets, nlive, lo_rc in arms_of(
                hw, device, batch=batch, sparsity=sparsity, arms=arms,
                rng=rng):
            try:
                with torch.inference_mode():
                    got = fn(*sets[0]).float()
                    want = ref(*sets[0])
                    err = (got - want).abs().max().item()
                    t = device_time(fn, *sets[0], iters=iters,
                                    arg_sets=sets)
                rows.append(emit(shape=tag, arm=name, us=round(t * 1e6, 2),
                                 err=err, ref_max=want.abs().max().item(),
                                 live=nlive, offsets=str(lo_rc)))
            except Exception as e:  # noqa: BLE001 - the script's error row
                rows.append(emit(shape=tag, arm=name, error=repr(e)[:200]))
    return rows


def main(argv=None) -> int:
    ap = common.parser("k3", __doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--shapes", default="56,28,14,7",
                    help="comma list of map sizes to run")
    ap.add_argument("--arms", default=ARMS)
    args = ap.parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    run(device, common.Rows(args.out, device),
        hws=[int(s) for s in args.shapes.split(",") if s], batch=args.batch,
        sparsity=args.sparsity, arms=args.arms)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The W-pair packed layout on the C=64 towers, arm by arm (port of
``scripts/exp_wpack_r5.py``): the packed reparametrizations
(``ops/wpack.py``) against the unpacked executors on ResNet-50's stage-1
shapes at b32 (``--hw 56 --cin 64 --big 256``), weights of the 3x3 pruned
to 90% in 128x128 blocks, bf16:

  k3_unpacked      the XBSP unroll
  k3_packed_conv   packed-domain conv, kernel cropped to the live packed taps
  k3_packed_xbsp   packed-domain XBSP unroll on the packed aligned weight
  entry_unpacked   1x1 big->c dense conv (the tower's entry)
  entry_packed     (1, kw_e) kernel at W stride r, emitting packed output
  exit_unpacked    1x1 c->big dense conv (the tower's exit)
  exit_packed      W-dilated conv consuming packed input
  tower_unpacked   entry -> sparse k3 -> exit + residual, ReLUs
  tower_packed     the same in the packed domain

Each arm is timed by ``device_time`` over CUDA-graph replays cycling 4
inputs; the ``max_err`` of the script's checks (packed against unpacked on
the first input) rides on the arms it concerns, with ``ref_max``, the
unpacked output's max|.|.

    python -m caffe_escoin_tpu_torch.experiments.wpack [--platform cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.experiments import common
from caffe_escoin_tpu_torch.experiments.k3 import conv_nhwc
from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
from caffe_escoin_tpu_torch.ops import wpack
from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
from caffe_escoin_tpu_torch.utils.benchmark import device_time
from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

ITERS = 12


def _maxerr(a, b):
    """(max |a - b|, max |a|): a check's error and its reference's scale."""
    a = a.float()
    return (a - b.float()).abs().max().item(), a.abs().max().item()


def build(device, *, batch=32, sparsity=0.9, hw=56, cin=64, big=256):
    """Everything the arms need: inputs, weights (unpacked and packed), the
    two towers and the script's three checks; see ``run``."""
    n, c = batch, cin
    r = wpack.pack_factor(c, hw)
    if r <= 1:
        raise ValueError(f"nothing to pack at c={c}, w={hw}")
    policy = ExecutionPolicy(block_shape=common.BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False)
    rng = np.random.default_rng(0)

    def draw(shape, scale):
        return rng.standard_normal(shape).astype(np.float32) * scale

    xbig = [torch.from_numpy(draw((n, hw, hw, big), .1)).to(
        device, torch.bfloat16) for _ in range(4)]
    xsm = [torch.from_numpy(draw((n, hw, hw, c), .1)).to(
        device, torch.bfloat16) for _ in range(4)]
    xsm_p = [wpack.pack_nhwc(v, r) for v in xsm]

    w_entry = draw((1, 1, big, c), .05)
    w_k3 = prune_conv_weight(draw((3, 3, c, c), .05), sparsity, common.BLOCK)
    w_exit = draw((1, 1, c, big), .05)

    def dev(w):
        return torch.from_numpy(np.ascontiguousarray(w)).to(device,
                                                            torch.bfloat16)

    aligned = weight_align(w_k3, None, policy=policy).to(device,
                                                         torch.bfloat16)
    wk3_b = dev(w_k3)

    # the packed 3x3, cropped to the (kh, kw_p) taps that hold a nonzero:
    # the packed-domain bounding box
    wp_k3, (pl3, _) = wpack.packed_weight(w_k3, r, 1)
    pr3 = wpack.packed_pad_right(hw, 3, 1, r)
    tap_nz = np.abs(wp_k3).sum(axis=(2, 3)) > 0
    rs, cs = np.where(tap_nz.any(axis=1))[0], np.where(tap_nz.any(axis=0))[0]
    r0, r1, c0, c1 = rs.min(), rs.max(), cs.min(), cs.max()
    k3_pad = ((1 - r0, r1 - 1),
              (pl3 - c0, c1 - (wp_k3.shape[1] - 1) + pr3))
    wp_k3_b = dev(wp_k3[r0:r1 + 1, c0:c1 + 1])
    common.log(f"packed k3: kw_p={wp_k3.shape[1]} live taps rows {r0}-{r1} "
               f"cols {c0}-{c1}")

    we_p, (epl, _), esw = wpack.entry_weight(w_entry, r, 1, 0)
    epr = wpack.entry_pad_right(hw, 1, 1, 0, r)
    we_p_b, we_b = dev(we_p), dev(w_entry)
    wx_p, (xpl, _), xdil = wpack.exit_weight(w_exit, r, 0)
    xpr = wpack.exit_pad_right(hw // r, 1, 0, r)
    wx_p_b, wx_b = dev(wx_p), dev(w_exit)

    def k3_packed(y):
        return conv_nhwc(y, wp_k3_b, pad=k3_pad)

    def entry_unpacked(y):
        return conv_nhwc(y, we_b)

    def entry_packed(y):
        return conv_nhwc(y, we_p_b, stride=(1, esw), pad=((0, 0), (epl, epr)))

    def exit_unpacked(y):
        return conv_nhwc(y, wx_b)

    def exit_packed(y):
        return conv_nhwc(y, wx_p_b, pad=((0, 0), (xpl, xpr)),
                         lhs_dilation_w=xdil)

    def tower_unpacked(y):
        a = torch.relu(entry_unpacked(y)).contiguous()
        b = xbs.conv(a, aligned, padding=(1, 1), relu=True)
        return torch.relu(exit_unpacked(b) + y)

    def tower_packed(y):
        a = torch.relu(entry_packed(y))
        b = torch.relu(k3_packed(a))
        o = exit_packed(b)
        return torch.relu(o + y)

    k3_ref = conv_nhwc(xsm[0], wk3_b, pad=((1, 1), (1, 1)))
    errs = {
        "k3": _maxerr(k3_ref, k3_packed(xsm_p[0]).reshape(k3_ref.shape)),
        "entry": _maxerr(
            entry_unpacked(xbig[0]),
            entry_packed(xbig[0]).reshape(n, hw, hw, c)),
        "exit": _maxerr(exit_unpacked(xsm[0]), exit_packed(xsm_p[0])),
        "tower": _maxerr(tower_unpacked(xbig[0]), tower_packed(xbig[0])),
    }
    common.log(f"max errs: {errs}")
    aligned_p = weight_align(wp_k3, None, policy=policy).to(device,
                                                            torch.bfloat16)
    return dict(
        r=r, n=n, hw=hw, c=c, pl3=pl3, pr3=pr3, aligned=aligned,
        aligned_p=aligned_p, xbig=xbig, xsm=xsm, xsm_p=xsm_p, errs=errs,
        k3_packed=k3_packed, entry_unpacked=entry_unpacked,
        entry_packed=entry_packed, exit_unpacked=exit_unpacked,
        exit_packed=exit_packed, tower_unpacked=tower_unpacked,
        tower_packed=tower_packed)


def run(device, emit, *, iters=ITERS, **shape):
    """The nine arms' rows (``us``, and ``max_err`` where the script set
    one); a ``skipped`` row for k3_packed_xbsp where the packed padding is
    asymmetric, an ``error`` row where an arm raised."""
    b = build(device, **shape)
    tag = f"{b['hw']}x{b['hw']} c{b['c']} r{b['r']} b{b['n']}"
    s_sm = [(v,) for v in b["xsm"]]
    s_smp = [(v,) for v in b["xsm_p"]]
    s_big = [(v,) for v in b["xbig"]]
    errs = b["errs"]
    aligned, aligned_p, pl3 = b["aligned"], b["aligned_p"], b["pl3"]
    arms = [
        ("k3_unpacked", lambda y: xbs.conv(y, aligned, padding=(1, 1)),
         s_sm, errs["k3"]),
        ("k3_packed_conv", b["k3_packed"], s_smp, errs["k3"]),
        ("k3_packed_xbsp", (lambda y: xbs.conv(y, aligned_p,
                                               padding=(1, pl3)))
         if pl3 == b["pr3"] else None, s_smp, None),
        ("entry_unpacked", b["entry_unpacked"], s_big, errs["entry"]),
        ("entry_packed", b["entry_packed"], s_big, None),
        ("exit_unpacked", b["exit_unpacked"], s_sm, errs["exit"]),
        ("exit_packed", b["exit_packed"], s_smp, None),
        ("tower_unpacked", b["tower_unpacked"], s_big, errs["tower"]),
        ("tower_packed", b["tower_packed"], s_big, None),
    ]
    rows = []
    for name, fn, sets, err in arms:
        if fn is None:
            rows.append(emit(shape=tag, arm=name,
                             skipped="asymmetric packed padding"))
            continue
        try:
            t = device_time(fn, *sets[0], iters=iters, arg_sets=sets)
            row = dict(shape=tag, arm=name, us=round(t * 1e6, 2))
            if err is not None:
                row["max_err"], row["ref_max"] = err
            rows.append(emit(**row))
        except Exception as e:  # noqa: BLE001 - the script's error row
            rows.append(emit(shape=tag, arm=name, error=repr(e)[:300]))
    return rows


def main(argv=None) -> int:
    ap = common.parser("wpack", __doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--hw", type=int, default=56)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--big", type=int, default=256,
                    help="entry/exit wide channel count")
    args = ap.parse_args(argv)
    device = common.device_of(args.platform)
    if device is None:
        return 2
    run(device, common.Rows(args.out, device), batch=args.batch, sparsity=args.sparsity, hw=args.hw, cin=args.cin,
        big=args.big)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Pretrained Caffe `.caffemodel` weights (binary NetParameter), read and
written (port of ``caffe_escoin_tpu/tools/caffemodel.py``; a copy, since the
port imports nothing of the JAX package).

The switching path for reference users: load the binaryproto files the
reference consumed (`Net::CopyTrainedLayersFrom`, `src/caffe/net.cpp:769+`,
including pruned SkimCaffe/GESL sparse models from `run.sh:3-5`) into the
port's params (CPU tensors), with the layout conversions the frameworks
disagree on, and write them back.

No protobuf runtime dependency: `.caffemodel` is parsed with a hand-rolled
protobuf WIRE-FORMAT walker against the field numbers of the reference's
schema (`src/caffe/proto/caffe.proto`):

  NetParameter   { name=1; layers(V1)=2; layer=100 }
  LayerParameter { name=1; type=2(string); blobs=7 }
  V1LayerParameter { name=4; type=5(enum); blobs=6 }
  BlobProto      { num/channels/height/width=1..4; data=5(packed float);
                   shape=7; double_data=8 }
  BlobShape      { dim=1 (packed int64) }

Layout conversions applied by ``assign_to_params``:
  * conv weights: Caffe [Cout, Cin/g, KH, KW] -> HWIO [KH, KW, Cin/g, Cout]
  * deconv weights: Caffe [Cin, Cout/g, KH, KW] (`deconv_layer.cpp` swaps
    the conv roles) -> [KH, KW, Cin, Cout]
  * fc weights:   Caffe [Cout, K] -> [K, Cout]; when the fc consumes a
    spatial blob, Caffe's K is flattened (c, h, w) while this framework
    flattens NHWC as (h, w, c) — rows are re-permuted using the known
    bottom shape (`Net.blob_shapes`).

``save_caffemodel`` writes the same bytes as the JAX package's for the same
params.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# V1LayerParameter.LayerType enum -> modern type string (caffe.proto:1227;
# only types that carry weights matter for weight import, the rest are kept
# for completeness of the upgrade path)
V1_LAYER_TYPES = {
    0: "None", 1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution",
    5: "Data", 6: "Dropout", 7: "EuclideanLoss", 8: "Flatten",
    9: "HDF5Data", 10: "HDF5Output", 11: "Im2col", 12: "ImageData",
    13: "InfogainLoss", 14: "InnerProduct", 15: "LRN", 16: "MultinomialLogisticLoss",
    17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "SoftmaxWithLoss", 22: "Split", 23: "TanH", 24: "WindowData",
    25: "Eltwise", 26: "Power", 27: "SigmoidCrossEntropyLoss",
    28: "HingeLoss", 29: "MemoryData", 30: "ArgMax", 31: "Threshold",
    32: "DummyData", 33: "Slice", 34: "MVN", 35: "AbsVal", 36: "Silence",
    37: "ContrastiveLoss", 38: "Exp", 39: "Deconvolution",
}


def _np(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _read_varint(buf: memoryview, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def walk(buf) -> Dict[int, List]:
    """Generic protobuf wire walker: field number -> list of raw values
    (int for varint/fixed, memoryview for length-delimited)."""
    buf = memoryview(buf)
    fields: Dict[int, List] = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:
            val = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _packed_floats(chunks: List) -> np.ndarray:
    # packed repeated float arrives as length-delimited chunks; unpacked
    # repeated float would arrive as wire-type-5 ints (bit patterns)
    parts = []
    for c in chunks:
        if isinstance(c, int):
            parts.append(np.asarray([c], np.int32).view(np.float32))
        else:
            parts.append(np.frombuffer(bytes(c), np.float32))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def _packed_varints(chunks: List) -> List[int]:
    out = []
    for c in chunks:
        if isinstance(c, int):
            out.append(c)
        else:
            mv = memoryview(c)
            i = 0
            while i < len(mv):
                v, i = _read_varint(mv, i)
                out.append(v)
    return out


def _parse_blob(raw) -> np.ndarray:
    f = walk(raw)
    data = _packed_floats(f.get(5, []))
    if not len(data) and 8 in f:  # double_data
        parts = [np.frombuffer(bytes(c), np.float64) for c in f[8]]
        data = np.concatenate(parts).astype(np.float32)
    if 7 in f:  # BlobShape
        dims = _packed_varints(walk(f[7][0]).get(1, []))
        shape = tuple(int(d) for d in dims)
    else:  # legacy NCHW fields
        legacy = [int(f.get(k, [0])[0]) for k in (1, 2, 3, 4)]
        shape = tuple(d for d in legacy if d) or (len(data),)
    return data.reshape(shape)


def load_caffemodel(path: str) -> Dict[str, Dict]:
    """Parse a .caffemodel: layer name -> {"type": str, "blobs": [ndarray]}
    (both modern `layer` and legacy V1 `layers` fields)."""
    with open(path, "rb") as fh:
        net = walk(fh.read())
    layers: Dict[str, Dict] = {}
    for raw in net.get(100, []):  # LayerParameter
        f = walk(raw)
        name = bytes(f[1][0]).decode() if 1 in f else "?"
        ltype = bytes(f[2][0]).decode() if 2 in f else "?"
        blobs = [_parse_blob(b) for b in f.get(7, [])]
        if blobs:
            layers[name] = {"type": ltype, "blobs": blobs}
    for raw in net.get(2, []):  # V1LayerParameter (legacy models)
        f = walk(raw)
        name = bytes(f[4][0]).decode() if 4 in f else "?"
        ltype = V1_LAYER_TYPES.get(int(f.get(5, [0])[0]), "?")
        blobs = [_parse_blob(b) for b in f.get(6, [])]
        if blobs:
            layers[name] = {"type": ltype, "blobs": blobs}
    return layers


def _conv_to_hwio(w: np.ndarray) -> np.ndarray:
    if w.ndim == 2:  # some exporters store [Cout, Cin] for 1x1
        w = w[:, :, None, None]
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _fc_rows_chw_to_hwc(w_km: np.ndarray,
                        bottom_shape: Optional[Tuple[int, ...]]):
    """Reorder fc rows from Caffe's (c,h,w) flatten to NHWC's (h,w,c)."""
    if bottom_shape is None or len(bottom_shape) != 4:
        return w_km
    _, h, wd, c = bottom_shape
    k, m = w_km.shape
    if k != h * wd * c or h * wd == 1:
        return w_km
    return w_km.reshape(c, h, wd, m).transpose(1, 2, 0, 3).reshape(k, m)


# layer types whose output rows keep the producer's (spatial, channel)
# element order, so the fc-row reorder can look through them to the
# nearest 4-D producer blob
_FLATTEN_LIKE = {"Flatten", "Reshape", "Dropout", "ReLU", "Split"}


def _trace_fc_bottom_shape(net, bottom: Optional[str], k: int, log=print):
    """Resolve the spatial (N,H,W,C) shape feeding an fc layer, looking
    through Flatten/Reshape (whose bottoms keep Caffe's (c,h,w) element
    order) so the row reorder still applies when the model flattens
    explicitly before InnerProduct (a 2-D bottom would keep Caffe's row
    order and give wrong fc outputs)."""
    shapes = getattr(net, "blob_shapes", {})
    producers = {t: l.spec for l in net.layers for t in l.spec.tops}
    seen = 0
    while bottom is not None and seen < 16:
        shape = shapes.get(bottom)
        if shape is not None and len(shape) == 4:
            return shape
        spec = producers.get(bottom)
        if spec is None or spec.type not in _FLATTEN_LIKE or not spec.bottoms:
            break
        bottom = spec.bottoms[0]
        seen += 1
    if seen:  # there WAS a flatten chain but no 4-D producer behind it
        log(f"caffemodel: WARNING — fc bottom {bottom!r} is flattened but "
            f"no 4-D producer found; keeping Caffe (c,h,w) row order "
            f"(outputs may be permuted)")
    return None


def assign_to_params(net, params: Dict, loaded: Dict[str, Dict],
                     *, strict: bool = False, log=print) -> Dict:
    """CopyTrainedLayersFrom semantics (`net.cpp:769+`): match layers by
    name, convert layouts, leave unmatched layers at their initialization.
    Returns a new params dict whose imported entries are float32 CPU
    tensors; a layer type without an import rule is skipped (``strict``
    raises), and a rule whose keys or shapes do not match the layer's
    params raises. BatchNorm blobs go to the net's state through
    ``batchnorm_state``."""
    out = dict(params)
    matched = 0
    for layer in net.layers:
        name = layer.spec.name
        if name not in loaded or name not in out:
            continue
        blobs = loaded[name]["blobs"]
        p = dict(out[name])
        t = layer.spec.type
        if t in ("Convolution", "ConvolutionReLU", "EscConvolution"):
            p["w"] = _conv_to_hwio(blobs[0])
            if len(blobs) > 1 and "b" in p:
                p["b"] = blobs[1].reshape(-1)
        elif t == "Deconvolution":
            p["w"] = np.ascontiguousarray(blobs[0].transpose(2, 3, 0, 1))
            if len(blobs) > 1 and "b" in p:
                p["b"] = blobs[1].reshape(-1)
        elif t == "InnerProduct":
            w = blobs[0]
            if w.ndim > 2:  # stored as [1,1,Cout,K] in some legacy models
                w = w.reshape(w.shape[-2], w.shape[-1])
            w = np.ascontiguousarray(w.T)  # [K, Cout]
            bottom = layer.spec.bottoms[0] if layer.spec.bottoms else None
            bshape = _trace_fc_bottom_shape(net, bottom, w.shape[0], log=log)
            p["w"] = _fc_rows_chw_to_hwc(w, bshape)
            if len(blobs) > 1 and "b" in p:
                p["b"] = blobs[1].reshape(-1)
        elif t == "Scale":
            # framework ScaleLayer param keys (nn/layers.py ScaleLayer):
            # gamma (blobs[0]) / beta (blobs[1])
            p["gamma"] = blobs[0].reshape(-1)
            if len(blobs) > 1:
                if "beta" not in p:
                    log(f"caffemodel: WARNING — {name} has a bias blob but "
                        f"the spec sets bias_term=False; dropping beta")
                else:
                    p["beta"] = blobs[1].reshape(-1)
        elif t == "PReLU":
            p["alpha"] = blobs[0].reshape(-1)
        else:
            if strict:
                raise ValueError(f"no import rule for layer type {t!r}")
            log(f"caffemodel: skipping {name} (type {t}, "
                f"{len(blobs)} blobs)")
            continue
        # shape check, then float32 tensors. A key the layer's init never
        # produced means the import rule and the layer disagree: an error,
        # not a skip.
        for k, v in list(p.items()):
            ref = params[name].get(k) if isinstance(params[name], dict) \
                else None
            if ref is None:
                raise ValueError(
                    f"{name}.{k}: imported param key not present in the "
                    f"framework layer's params "
                    f"({sorted(params[name])}) — import-rule mismatch")
            if tuple(np.shape(ref)) != tuple(np.shape(v)):
                raise ValueError(
                    f"{name}.{k}: shape {np.shape(v)} does not match "
                    f"model {tuple(np.shape(ref))}")
            p[k] = torch.tensor(_np(v), dtype=torch.float32)
        out[name] = p
        matched += 1
    log(f"caffemodel: imported {matched} layers")
    return out


# ---------------------------------------------------------------------------
# Export: the reverse direction (`Solver::Snapshot` writes .caffemodel via
# `Net::ToProto`, `src/caffe/net.cpp:910+` / `solver.cpp:403-461`). Emitting
# the same wire format this importer reads makes the interop bidirectional:
# a net trained HERE can be snapshotted into the reference's format, and the
# round-trip (save -> load -> assign) is an exact-parity check on the layout
# conversions above.
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """Length-delimited (wire type 2) field."""
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _blob_bytes(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    shape = _field(7, _field(1, dims))  # BlobShape{dim=1 packed int64}
    data = _field(5, arr.reshape(-1).tobytes())  # packed float
    return shape + data


def _hwio_to_caffe_conv(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(3, 2, 0, 1))


def _fc_rows_hwc_to_chw(w_km: np.ndarray,
                        bottom_shape: Optional[Tuple[int, ...]]):
    """Inverse of `_fc_rows_chw_to_hwc`."""
    if bottom_shape is None or len(bottom_shape) != 4:
        return w_km
    _, h, wd, c = bottom_shape
    k, m = w_km.shape
    if k != h * wd * c or h * wd == 1:
        return w_km
    return w_km.reshape(h, wd, c, m).transpose(2, 0, 1, 3).reshape(k, m)


def save_caffemodel(net, params: Dict, path: str, *,
                    state: Optional[Dict] = None,
                    net_name: str = "net", log=print) -> int:
    """Write net params (and BatchNorm moving stats from `state`) as a
    modern-format `.caffemodel` (NetParameter with `layer` field 100).

    Returns the number of layers exported. Layer types without blobs are
    emitted without a blobs field (like `Net::ToProto`, which serializes
    every layer's — possibly empty — blob list; readers only care about
    the ones that carry weights)."""
    state = state or {}
    chunks = [_field(1, net_name.encode())]
    exported = 0
    for layer in net.layers:
        name = layer.spec.name
        t = layer.spec.type
        p = params.get(name, {})
        blobs: List[np.ndarray] = []
        if t in ("Convolution", "ConvolutionReLU", "EscConvolution") \
                and "w" in p:
            blobs.append(_hwio_to_caffe_conv(p["w"]))
            if "b" in p:
                blobs.append(_np(p["b"]).reshape(-1))
        elif t == "Deconvolution" and "w" in p:
            blobs.append(np.ascontiguousarray(_np(p["w"]).transpose(2, 3, 0,
                                                                    1)))
            if "b" in p:
                blobs.append(_np(p["b"]).reshape(-1))
        elif t == "InnerProduct" and "w" in p:
            w = _np(p["w"])  # [K, Cout]
            bottom = layer.spec.bottoms[0] if layer.spec.bottoms else None
            bshape = _trace_fc_bottom_shape(net, bottom, w.shape[0],
                                            log=lambda *_: None)
            w = _fc_rows_hwc_to_chw(w, bshape)
            blobs.append(np.ascontiguousarray(w.T))  # [Cout, K]
            if "b" in p:
                blobs.append(_np(p["b"]).reshape(-1))
        elif t == "Scale" and "gamma" in p:
            blobs.append(_np(p["gamma"]).reshape(-1))
            if "beta" in p:
                blobs.append(_np(p["beta"]).reshape(-1))
        elif t == "PReLU" and "alpha" in p:
            blobs.append(_np(p["alpha"]).reshape(-1))
        elif t == "BatchNorm" and name in state:
            s = state[name]
            blobs = [_np(s["mean_acc"]).reshape(-1),
                     _np(s["var_acc"]).reshape(-1),
                     _np(s["count"]).reshape(1)]
        lp = _field(1, name.encode()) + _field(2, t.encode())
        for b in blobs:
            lp += _field(7, _blob_bytes(b))
        chunks.append(_field(100, lp))
        if blobs:
            exported += 1
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))
    log(f"caffemodel: exported {exported} weighted layers -> {path}")
    return exported


def batchnorm_state(loaded: Dict[str, Dict]) -> Dict[str, Dict]:
    """Extract BatchNorm moving stats in the port's state schema (CPU
    tensors).

    Caffe stores (mean_sum, var_sum, scale_factor) and divides by
    scale_factor at use (`batch_norm_layer.cpp:13-16,96-106`); the
    BatchNormLayer state keeps exactly those three — {mean_acc, var_acc,
    count} — so the blobs map one-to-one. Merge the result into the net's
    state: ``net.state0.update(batchnorm_state(loaded))`` after ``init``
    (or pass it as ``Net.forward(state=...)``)."""
    out = {}
    for name, entry in loaded.items():
        if entry["type"] != "BatchNorm" or len(entry["blobs"]) < 3:
            continue
        mean_s, var_s, sf = entry["blobs"][:3]
        out[name] = {"mean_acc": torch.tensor(mean_s.reshape(-1),
                                              dtype=torch.float32),
                     "var_acc": torch.tensor(var_s.reshape(-1),
                                             dtype=torch.float32),
                     "count": torch.tensor(sf.reshape(-1)[0],
                                           dtype=torch.float32)}
    return out

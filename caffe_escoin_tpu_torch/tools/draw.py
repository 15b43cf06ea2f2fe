"""Net visualization: LayerSpec graph -> Graphviz DOT text (port of
``caffe_escoin_tpu/tools/draw.py``; a copy, the same text).

The `python/caffe/draw.py` counterpart. Emits DOT source directly (no
pydot/graphviz dependency — render with any dot tool); layer nodes are
colored by category like the reference (`draw.py:117-127`), edges carry the
blob names, conv/pool nodes annotate their geometry (`draw.py:46-60`).
"""

from __future__ import annotations

from typing import List, Optional

_COLORS = {
    "Convolution": "#FF5050",
    "ConvolutionReLU": "#FF5050",
    "EscConvolution": "#FF9900",
    "Deconvolution": "#FF5050",
    "InnerProduct": "#CC33CC",
    "Pooling": "#66CC66",
    "SPP": "#66CC66",
    "Concat": "#3399FF",
    "Eltwise": "#3399FF",
}
_DEFAULT_COLOR = "#6495ED"


def _label(spec) -> str:
    p = spec.params or {}
    bits = [f"{spec.name}", f"({spec.type})"]
    if spec.type in ("Convolution", "ConvolutionReLU", "EscConvolution",
                     "Deconvolution"):
        k = p.get("kernel", 3)
        bits.append(f"k{k} s{p.get('stride', 1)} p{p.get('pad', 0)}"
                    f" -> {p.get('num_output', '?')}")
        if p.get("group", 1) > 1:
            bits.append(f"g{p['group']}")
    elif spec.type == "Pooling":
        bits.append(f"{p.get('pool', 'max')} k{p.get('kernel', 2)}"
                    f" s{p.get('stride', 2)}")
    elif spec.type == "InnerProduct":
        bits.append(f"-> {p.get('num_output', '?')}")
    return "\\n".join(bits)


def net_to_dot(specs: List, *, name: str = "net", rankdir: str = "LR",
               phase: Optional[str] = None) -> str:
    """LayerSpec list -> DOT source string (draw.py:130-203)."""
    lines = [f'digraph "{name}" {{', f"  rankdir={rankdir};",
             "  node [shape=record, style=filled];"]
    blob_producer = {}
    for spec in specs:
        if phase is not None and getattr(spec, "phase", None) not in (
                None, phase):
            continue
        color = _COLORS.get(spec.type, _DEFAULT_COLOR)
        lines.append(
            f'  "{spec.name}" [label="{_label(spec)}", fillcolor="{color}"];')
        for bottom in spec.bottoms:
            src = blob_producer.get(bottom)
            if src is not None:
                lines.append(f'  "{src}" -> "{spec.name}" '
                             f'[label="{bottom}"];')
        for top in spec.tops:
            blob_producer[top] = spec.name
    lines.append("}")
    return "\n".join(lines)


def draw_net_to_file(specs: List, filename: str, **kw) -> None:
    """Write DOT source (render with `dot -Tpng`; draw.py:226-244)."""
    with open(filename, "w") as f:
        f.write(net_to_dot(specs, **kw))

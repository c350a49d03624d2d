"""Quantized execution plans: an ordered tag -> policy table, first match
wins, a ``None`` policy keeps the layer bf16 (the port's copy of
``repro/core/qplan.py``).

``backend`` is the kernel backend every planned layer dispatches with:
'auto' (kernel for CUDA tensors, plain version for CPU tensors), 'cuda' or
'ref' (see kernels/registry.py). The reference's autotuner field ``tune``
waits for the autotuner (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .qlinear import QuantPolicy, tag_matches  # noqa: F401


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    rules: tuple = ()
    backend: str = "auto"

    def policy_for(self, tag: str) -> Optional[QuantPolicy]:
        for pattern, pol in self.rules:
            if tag_matches(pattern, tag):
                if pol is None or pol.w_bits is None or pol.kernel == "bf16":
                    return None
                return pol
        return None


# layer classes every preset keeps in bf16
KEEP_BF16 = ("router", "embed", "norm", "lm_head", "pos")


def make_plan(w_bits: int = 2, a_bits: Optional[int] = None,
              group_size: Optional[int] = None, *, backend: str = "auto",
              scheme: str = "d", nonuniform: bool = False, signed: bool = True,
              a_scale: str = "dynamic", kernel: str = "auto",
              keep: tuple = KEEP_BF16, rules: tuple = ()) -> QuantPlan:
    """Keep-list rules first (bf16), then extra ``rules``, then a catch-all
    policy."""
    default = QuantPolicy(
        w_bits=w_bits, a_bits=a_bits, group_size=group_size, signed=signed,
        scheme=scheme, nonuniform=nonuniform, kernel=kernel, a_scale=a_scale)
    keep_rules = tuple((pattern, None) for pattern in keep)
    return QuantPlan(rules=keep_rules + tuple(rules) + (("*", default),),
                     backend=backend)


def _mixed_plan() -> QuantPlan:
    attn = QuantPolicy(w_bits=4, a_bits=None, group_size=64, kernel="auto")
    return make_plan(2, 2, group_size=64, rules=(("attn", attn),))


PLANS = {
    "bf16": QuantPlan(rules=(("*", None),)),
    "w2a16": make_plan(2),
    "w2a16g64": make_plan(2, group_size=64),
    "w2a16g128": make_plan(2, group_size=128),
    "w2a2": make_plan(2, 2),
    "w2a2g64": make_plan(2, 2, group_size=64),
    "w4a16": make_plan(4),
    "w4a8": make_plan(4, 8),
    "mixed_attn4_mlp2": _mixed_plan(),
    # bit-sliced routes: packing them raises until that slice is ported
    "w2a8_bs": make_plan(2, 8, kernel="lut_gemm_bitsliced"),
    "w2a8_bs_g64": make_plan(2, 8, group_size=64, kernel="lut_gemm_bitsliced"),
    "w4a8_bs": make_plan(4, 8, kernel="lut_gemm_bitsliced"),
}


def get_plan(name: str) -> QuantPlan:
    if name not in PLANS:
        raise KeyError(f"unknown plan {name!r}; have {sorted(PLANS)}")
    return PLANS[name]


def plan_backend(plan) -> str:
    return getattr(plan, "backend", "auto")

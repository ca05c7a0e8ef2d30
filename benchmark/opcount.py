"""FP32 operations a view of stages 2 and 3 needs, counted from shapes, for ``step_mfu``.

The count is of what the algorithm needs, whatever implements it: padded
points, rays past their budget and recomputation (checkpointing) are not
counted, and an FMA counts as 2, a division, square root or exp as 1. The
constants are per unit of work and derived below from the arithmetic of
the shading code (``ops/envshade.py``, ``ops/sdf_visibility.py``) and the
field (``models/geosplat.py``); the kernels' terms are ``roofline.py``'s.

A view's terms:
- the sphere trace: 2 rays (the light and the BSDF sample) x S steps x N
  shaded points, each ray ``shadow_steps`` steps of TRACE_STEP_OPS;
- the Monte-Carlo shading: S x N x (SAMPLE_STEP_OPS to draw both samples
  and their pdfs + 2 x EVAL_SAMPLE_OPS to evaluate them);
- the field's networks: 2 x weights x points, plus the triplane lookups;
- K1 (and K2 in training): the pair-pixel counts of ``roofline.pass_work``;
- in training, the backward of the differentiable terms counted once as
  twice their forward (the Monte-Carlo evaluation and the field), plus K2.
The sampling and the trace are gradient-free and have no backward.
"""
from __future__ import annotations

# One sphere-tracing step of one ray (sdf_visibility.make_sdf_visibility):
# the point o + t d (3 FMA = 6); grid coordinates (p / s * 0.5 + 0.5) * r
# (3 x 3 = 9), floor and fraction (6), the clamped cell index (6 + 4);
# trilinear weights (3 complements, 4 + 8 products = 15); the 8-corner dot
# (8 FMA = 16); the box distance (|p| - s 6, clamp 3, squared norm 5, sqrt
# 1, select 2 = 17); the softness ratio and running minimum (6); the step
# update with its clamps (3). Total 88.
TRACE_STEP_OPS = 88

# Drawing one step's two samples at one point (envshade._draw_samples): the
# bank direction's pdf plus the BSDF pdf of it (GGX-VNDF pdf ~40, the
# cosine pdf 6, the mix 4 = 50); the cosine sample (sin / cos 2, sqrt 2,
# frame 18 = 22); the GGX-VNDF sample (stretch 6, normalise 8, frame 24,
# sqrt / trig 4, unstretch 10, reflect 12 = 64); the lobe choice and the
# pdf of the taken sample (14); the texel lookup and its pdf (12). Total 162.
SAMPLE_STEP_OPS = 162

# Evaluating one sample at one point (envshade._eval_sample): Lambert (dot
# 5, clamp and / pi 2 = 7); the specular colour (3 channels x 4 = 12); alpha
# and its clamp (3); the half vector (add 3, dot 5, rsqrt 1, scale 3 = 12);
# four dots (20); the GGX NDF (8); two Smith lambdas (2 x 9) and the
# masking (3); Fresnel (clamp 2, fifth power 3, 3 channels x 4 = 17); the
# specular weight (6); the MIS weight times the light colour (5); diffuse
# and specular times visibility (12); the residual pair (14); accumulation
# (8). Total 150.
EVAL_SAMPLE_OPS = 150


def field_ops(components: int, hidden: int, heads: tuple[int, ...], lookups: int) -> int:
    """One point through a triplane trunk and bias-free heads of one hidden
    layer: each trunk lookup is 3 planes x 4 bilinear taps x C components
    (an FMA each, 24 C) plus the sum of the planes (2 C); each head
    2 x (C x hidden + hidden x out)."""
    trunk = lookups * (24 * components + 2 * components)
    return trunk + sum(2 * (components * hidden + hidden * out) for out in heads)


def shading_ops(points: float, samples: int, shadow_steps: int) -> dict:
    return {
        "sphere_trace": 2 * samples * points * shadow_steps * TRACE_STEP_OPS,
        "sampling": samples * points * SAMPLE_STEP_OPS,
        "mc_eval": samples * points * 2 * EVAL_SAMPLE_OPS,
    }


def view_ops(work: dict, training: bool) -> dict:
    """The terms of one view. ``work`` holds ``shaded_points``, ``samples``
    (S = num_samples_x^2), ``shadow_steps``, ``field_points``,
    ``field_ops_per_point`` and the kernels' ``k1_ops`` / ``k2_ops``."""
    terms = shading_ops(work["shaded_points"], work["samples"], work["shadow_steps"])
    terms["field"] = work["field_points"] * work["field_ops_per_point"]
    terms["k1"] = work["k1_ops"]
    if training:
        terms["backward"] = 2 * (terms["mc_eval"] + terms["field"])
        terms["k2"] = work["k2_ops"]
    terms["total"] = sum(terms.values())
    return terms

"""Port parity: the standalone 2-D texture op (torch, plain twins) vs the
JAX package's ``texture`` (Pallas kernels in interpret mode; XLA for
'nearest', which has no kernel), every filter mode x the wrap, clamp and
zero boundaries: the image within 1e-6 absolute and the gradients of
sum(o**2 + 0.1*o) to the texture, uv and uv_da, each row within 5e-5 of
its largest entry (tests/test_pipeline_tex.py:61's bar, per row). The
mip options (bias, mip stacks, max_mip_level, per-image textures, C > 8)
are in test_torch_texture_op_mip.py.
"""

import pytest

from _torch_parity import check_texture, texture_case

FILTERS = ("nearest", "linear", "linear-mipmap-nearest", "linear-mipmap-linear")


@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_texture_matches_jax(filter_mode, boundary_mode):
    args = texture_case(seed=1)
    args["bias"] = None
    if "mipmap" not in filter_mode:
        args["uv_da"] = None
    ref = check_texture(args, dict(filter_mode=filter_mode, boundary_mode=boundary_mode))
    if filter_mode != "nearest":
        assert abs(ref["uv"]).max() > 0

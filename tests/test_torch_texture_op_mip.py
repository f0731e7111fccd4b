"""Port parity: the standalone 2-D texture op's mip options (torch, plain
twins) vs the JAX package's ``texture`` (Pallas kernels in interpret
mode; its XLA path for C > 8, which its kernels do not serve):
'auto', mip_level_bias alone and with uv_da, a TextureMipWrapper built
from the texture (its gradient reaches the texture through the stack),
a mip list whose entries take the gradients, max_mip_level=0, per-image
textures (D = B) and 9 channels (two groups of the 8-channel kernels).
A tensor argument on another device than uv raises ValueError.
Bars as test_torch_texture_op.py (``_torch_parity.check_texture``).
"""

import numpy as np
import pytest
import torch

from _torch_parity import check_texture, texture_case

MIP = dict(filter_mode="linear-mipmap-linear", boundary_mode="wrap")


@pytest.mark.parametrize("with_da", [True, False])
def test_texture_auto_filter(with_da):
    args = texture_case(seed=2)
    args["bias"] = None
    if not with_da:
        args["uv_da"] = None
    check_texture(args, dict(filter_mode="auto", boundary_mode="clamp"))


@pytest.mark.parametrize("with_da", [False, True])
def test_texture_mip_level_bias(with_da):
    args = texture_case(seed=3)
    if not with_da:
        args["uv_da"] = None
    ref = check_texture(args, dict(MIP))
    assert np.abs(ref["bias"]).max() > 0


def test_texture_mip_wrapper_gradient_reaches_tex():
    args = texture_case(seed=4)
    args["bias"] = None
    check_texture(args, dict(MIP), wrapper_max=3)


def test_texture_mip_list_takes_gradients():
    args = texture_case(seed=5)
    rng = np.random.RandomState(6)
    args["mip"] = [rng.rand(1, 16 >> k, 32 >> k, 3).astype(np.float32) for k in (1, 2, 3)]
    ref = check_texture(args, dict(MIP, boundary_mode="zero"))
    assert all(np.abs(g).max() > 0 for g in ref["mip"])


def test_texture_max_mip_level_zero_is_linear():
    args = texture_case(seed=7)
    ref = check_texture(args, dict(MIP, max_mip_level=0))
    assert np.abs(ref["uv_da"]).max() == 0 and np.abs(ref["bias"]).max() == 0


def test_texture_per_image_textures():
    args = texture_case(seed=8, D=2)
    args["bias"] = None
    check_texture(args, dict(MIP, boundary_mode="clamp"))


@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-linear"])
def test_texture_nine_channels(filter_mode):
    args = texture_case(seed=9, C=9)
    if filter_mode == "linear":
        args["uv_da"] = args["bias"] = None
    else:
        args["bias"] = None
    check_texture(args, dict(filter_mode=filter_mode, boundary_mode="wrap"))


@pytest.mark.parametrize("where", ["tex", "uv_da", "mip_level_bias", "mip"])
def test_texture_refuses_mixed_devices(where):
    # A tensor on another device than uv is refused, never copied over:
    # the meta device stands in for the card here.
    from nvdiffrast_tpu_torch.ops.texture import texture

    uv = torch.rand(1, 4, 4, 2)
    args = dict(tex=torch.rand(1, 8, 8, 3), uv_da=torch.rand(1, 4, 4, 4),
                mip_level_bias=torch.zeros(1, 4, 4), mip=[torch.rand(1, 4, 4, 3)])
    if where == "mip":
        args["mip"] = [torch.empty(1, 4, 4, 3, device="meta")]
    else:
        args[where] = torch.empty(args[where].shape, device="meta")
    with pytest.raises(ValueError, match=r"meta.*uv is on cpu"):
        texture(args.pop("tex"), uv, filter_mode="linear-mipmap-linear", **args)

"""3D U-Net for the learned viscosity operator.

Counterpart of ``python_fluid_simulation_tpu/models/unet3d.py`` and the
reference's ``model_3d.py`` UNet (:9-136): 4 ``AvgPool3d(2)``
downsamples, encoder 64-64 / 128-128 / 256-256 / 512-512 / 1024
bottleneck, decoder with ``ConvTranspose3d(k2, s2)`` unpooling and skip
concats, every block ``Conv3d(k3, s1, p1)`` + Tanh (`CBR3d`,
model_3d.py:14-24), and a 1x1x1 ``fc`` conv to 3 channels (:82).

Layout is channels-first (N, C, D, H, W), PyTorch's own.  The attribute
names are the reference's, so its state_dict keys (``enc1_1.0.weight``,
``unpool4.weight``, ``fc.bias``, ...) load with ``load_state_dict`` and no
remapping; ``convert.py`` carries Flax checkpoints of the JAX package
across.  ``UNet3D(fast_unpool=True)`` (the JAX field of that name) runs
each unpool as `FastUnpool`: one matmul and a depth-to-space interleave,
with the transposed conv's parameters, so checkpoints are shared.

Precision is explicit, never inherited from process-wide flags:
``dtype=torch.float32`` runs every conv in fp32 with TF32 off (cuDNN
deterministic, no autotuning), the JAX package's fp32 semantics, and a
step repeats bitwise; ``dtype=torch.bfloat16`` (JAX ``UNet3D(dtype=
bfloat16)``) keeps the parameters in fp32, computes in bf16 and returns
fp32.  `precise_flags` holds those flags; the forward and the trainer's
whole step (forward and backward, ``models/train.py``) run under it.
The pooling's backward (`AvgPool2`) is a gather, with no atomics, so a
training step repeats bitwise too.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def _conv(conv, x):
    """`conv` applied in the dtype of x (its fp32 parameters cast)."""
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride, conv.padding)


@contextlib.contextmanager
def precise_flags():
    """cuDNN deterministic, no autotuning, TF32 off in cuDNN and cuBLAS,
    whatever the process's flags say (restored on exit)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


class AvgPool2(torch.autograd.Function):
    """``F.avg_pool3d(x, 2)`` on even extents, whose backward is the gather
    form: each input voxel lies in one 2x2x2 block and takes its block's
    gradient / 8 (ATen's CUDA backward scatters with atomics)."""

    @staticmethod
    def forward(ctx, x):
        return F.avg_pool3d(x, 2)

    @staticmethod
    def backward(ctx, grad):
        n, c, d, h, w = grad.shape
        return (grad / 8).reshape(n, c, d, 1, h, 1, w, 1).expand(n, c, d, 2, h, 2, w, 2).reshape(
            n, c, 2 * d, 2 * h, 2 * w)


def fast_unpool(x, weight, bias):
    """``F.conv_transpose3d(x, weight, bias, stride=2)`` for a 2x2x2
    kernel (JAX ``FastUnpool``): kernel == stride, so each output voxel
    takes one input voxel's contribution, and the transposed conv is one
    matmul, (8F, C) by (C, voxels) (JAX's (voxels, C) by (C, 8F) in the
    channels-first layout), then a depth-to-space interleave, then the
    bias.  ``weight`` is (C, F, 2, 2, 2), as ``nn.ConvTranspose3d``'s."""
    n, c, d, h, w = x.shape
    f = weight.shape[1]
    y = torch.matmul(weight.reshape(c, 8 * f).t(), x.reshape(n, c, d * h * w))  # (n, 8F, voxels)
    # (n, F, i, j, k, D, H, W) -> (n, F, D, i, H, j, W, k) -> merge
    y = y.reshape(n, f, 2, 2, 2, d, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(n, f, 2 * d, 2 * h, 2 * w)
    return y + bias.reshape(1, f, 1, 1, 1)


class FastUnpool(nn.ConvTranspose3d):
    """``ConvTranspose3d(k2, s2)`` with its parameters (``weight``,
    ``bias``), run as `fast_unpool` in the dtype of its input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 2, 2, 0)

    def forward(self, x):
        return fast_unpool(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class CBR3d(nn.Sequential):
    """Conv3d(k3, s1, p1) + Tanh (model_3d.py:14-24), in the dtype of its
    input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Conv3d(in_channels, out_channels, 3, 1, 1), nn.Tanh())

    def forward(self, x):
        return torch.tanh(_conv(self[0], x))


class UNet3D(nn.Module):
    """The reference UNet (model_3d.py:9-136); ``width`` is the first
    level's channels (64 in the reference); ``fast_unpool`` runs the
    unpools as `FastUnpool` (the same parameters)."""

    def __init__(self, in_channels: int = 11, out_channels: int = 3, width: int = 64, dtype=torch.float32,
                 fast_unpool: bool = False):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"UNet3D: dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        w = width

        def unpool(c):
            return FastUnpool(c, c) if fast_unpool else nn.ConvTranspose3d(c, c, 2, 2, 0)

        self.enc1_1, self.enc1_2 = CBR3d(in_channels, w), CBR3d(w, w)
        self.enc2_1, self.enc2_2 = CBR3d(w, 2 * w), CBR3d(2 * w, 2 * w)
        self.enc3_1, self.enc3_2 = CBR3d(2 * w, 4 * w), CBR3d(4 * w, 4 * w)
        self.enc4_1, self.enc4_2 = CBR3d(4 * w, 8 * w), CBR3d(8 * w, 8 * w)
        self.enc5_1 = CBR3d(8 * w, 16 * w)
        self.dec5_1 = CBR3d(16 * w, 8 * w)
        self.unpool4 = unpool(8 * w)
        self.dec4_2, self.dec4_1 = CBR3d(16 * w, 8 * w), CBR3d(8 * w, 4 * w)
        self.unpool3 = unpool(4 * w)
        self.dec3_2, self.dec3_1 = CBR3d(8 * w, 4 * w), CBR3d(4 * w, 2 * w)
        self.unpool2 = unpool(2 * w)
        self.dec2_2, self.dec2_1 = CBR3d(4 * w, 2 * w), CBR3d(2 * w, w)
        self.unpool1 = unpool(w)
        self.dec1_2, self.dec1_1 = CBR3d(2 * w, w), CBR3d(w, w)
        self.fc = nn.Conv3d(w, out_channels, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C_in, D, H, W) -> (N, C_out, D, H, W) float32; D, H, W
        multiples of 16.  TF32 is off whatever the process's flags say."""
        with precise_flags():
            return self.forward_raw(x)

    def forward_raw(self, x: torch.Tensor) -> torch.Tensor:
        """`forward` under the caller's cuDNN flags (a TF32 timing, say)."""

        def pool(v):  # averaged in fp32 (the CPU has no bf16 avg_pool3d)
            return AvgPool2.apply(v.float()).to(v.dtype)

        def unpool(m, v):
            if isinstance(m, FastUnpool):
                return m(v)
            return F.conv_transpose3d(v, m.weight.to(v.dtype), m.bias.to(v.dtype), stride=2)

        x = x.to(self.dtype)
        e12 = self.enc1_2(self.enc1_1(x))
        e22 = self.enc2_2(self.enc2_1(pool(e12)))
        e32 = self.enc3_2(self.enc3_1(pool(e22)))
        e42 = self.enc4_2(self.enc4_1(pool(e32)))
        d51 = self.dec5_1(self.enc5_1(pool(e42)))
        d41 = self.dec4_1(self.dec4_2(torch.cat([unpool(self.unpool4, d51), e42], 1)))
        d31 = self.dec3_1(self.dec3_2(torch.cat([unpool(self.unpool3, d41), e32], 1)))
        d21 = self.dec2_1(self.dec2_2(torch.cat([unpool(self.unpool2, d31), e22], 1)))
        d11 = self.dec1_1(self.dec1_2(torch.cat([unpool(self.unpool1, d21), e12], 1)))
        return _conv(self.fc, d11).float()

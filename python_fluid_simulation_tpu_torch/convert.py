"""What carries between the two packages: simulation states and the
learned operator's weights.

``state_to_numpy`` / ``state_from_numpy`` map a `SimState` to and from a
flat dict of numpy arrays whose keys name the fields of the JAX
package's ``SimState`` (particles x/v/c/m, solid phi/v/rb, t, step_idx,
visc_mg), so the same state can be fed to both packages; a 2D state
((K, 2) positions, (K, 2, 2) APIC rows, the (B, 8, 3) ``sdf2d`` table)
carries the same way.

The UNet's weights carry from a Flax params tree (the JAX package's
``UNet3D``: channels-last kernels) to the port's ``models/unet3d.py``
state_dict, the inverse of the JAX package's ``models/convert.py``:

  Conv            kernel (kD, kH, kW, I, O) -> weight (O, I, kD, kH, kW)
  ConvTranspose   kernel (kD, kH, kW, I, O), un-flipped on the three
                  spatial axes -> weight (I, O, kD, kH, kW)
  biases          as they are

``load_flax_msgpack`` reads a Flax checkpoint (``flax.serialization.
to_bytes``) with the ``msgpack`` package alone; ``load_reference_checkpoint``
reads the reference's ``{'net': state_dict}`` torch files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState

_UNPOOL_NAMES = ("unpool4", "unpool3", "unpool2", "unpool1")


def state_to_numpy(s: SimState) -> dict:
    def np_(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    p, sol = s.particles, s.solid
    return {
        "x": np_(p.x), "v": np_(p.v), "c": np_(p.c), "m": np_(p.m),
        "phi": np_(sol.phi), "sv": np_(sol.v), "rb": np_(sol.rb),
        "t": np_(s.t).astype(np.float32),
        "step_idx": np_(s.step_idx).astype(np.int32),
        "visc_mg": np_(s.visc_mg).astype(np.int32),
    }


def state_from_numpy(d: dict, device="cuda") -> SimState:
    def t_(k, dtype=torch.float32):
        return torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)

    return SimState(
        particles=Particles(x=t_("x"), v=t_("v"), c=t_("c"), m=t_("m")),
        solid=SolidState(phi=t_("phi"), v=t_("sv"), rb=t_("rb")),
        t=t_("t"),
        step_idx=t_("step_idx", torch.int32),
        visc_mg=t_("visc_mg", torch.int32) if "visc_mg" in d else torch.zeros((), dtype=torch.int32, device=device),
    )


def unet_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The ``UNet3D`` state_dict (the reference's keys) of a Flax UNet3D
    params tree, with or without its top-level ``'params'`` key."""
    params = params.get("params", params)
    sd = {}
    for name, mod in params.items():
        if name in _UNPOOL_NAMES:
            k = np.asarray(mod["kernel"], np.float32)[::-1, ::-1, ::-1]
            sd[f"{name}.weight"] = np.transpose(k, (3, 4, 0, 1, 2))
            sd[f"{name}.bias"] = mod["bias"]
            continue
        conv, prefix = (mod, name) if name == "fc" else (mod["conv"], f"{name}.0")
        sd[f"{prefix}.weight"] = np.transpose(np.asarray(conv["kernel"], np.float32), (4, 3, 0, 1, 2))
        sd[f"{prefix}.bias"] = conv["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def load_flax_msgpack(path) -> dict:
    """The params tree (numpy arrays) of a Flax checkpoint written by
    ``flax.serialization.to_bytes``, decoded with ``msgpack`` alone:
    arrays are msgpack ext type 1 holding (shape, dtype name, C-order
    bytes)."""
    import msgpack

    def ext_hook(code, data):
        if code != 1:
            raise ValueError(f"load_flax_msgpack: msgpack ext type {code} in {path} is not an array")
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False, strict_map_key=False)


def load_reference_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference checkpoint (``{'net': state_dict}``,
    or a bare state_dict), on the CPU."""
    sd = torch.load(path, map_location="cpu")
    return sd["net"] if "net" in sd else sd


def random_flax_unet_params(width: int = 64, in_channels: int = 11, out_channels: int = 3, seed: int = 0) -> dict:
    """A Flax-layout UNet3D params tree drawn from ``numpy.random.
    default_rng(seed)``: kernels normal with std 1/sqrt(fan_in), biases
    uniform in +-1/sqrt(fan_in) (the card runs use it: the banked
    checkpoint does not reach the card)."""
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in UNet3D(in_channels, out_channels, width).state_dict().items()}
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in shapes.items():
        if not key.endswith(".weight"):
            continue
        name = key.split(".")[0]
        if name in _UNPOOL_NAMES:  # (I, O, k, k, k) -> (k, k, k, I, O)
            flax_shape = shape[2:] + shape[:2]
            fan_in = int(np.prod(shape[2:])) * shape[0]
        else:  # (O, I, k, k, k) -> (k, k, k, I, O)
            flax_shape = shape[2:] + (shape[1], shape[0])
            fan_in = int(np.prod(shape[1:]))
        scale = 1.0 / np.sqrt(fan_in)
        kernel = (rng.standard_normal(flax_shape, dtype=np.float32) * np.float32(scale)).astype(np.float32)
        bias = rng.uniform(-scale, scale, flax_shape[-1]).astype(np.float32)
        leaf = {"kernel": kernel, "bias": bias}
        params[name] = leaf if name in _UNPOOL_NAMES or name == "fc" else {"conv": leaf}
    return {"params": params}

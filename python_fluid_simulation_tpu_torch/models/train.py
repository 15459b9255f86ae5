"""The learned viscosity operator's trainer: counterpart of
``python_fluid_simulation_tpu/models/train.py``.

The reference trains its UNet offline on pairs captured from the
classical solver: in 'apic' mode the notebook stores the velocities
before and after the viscosity CG solve (cell 13 :4611-4630).  Here a
pair is the 11-channel feature box of ``features.py`` with the Δv·(1/DT)
target embedded at the face parities, channels-first
(`capture_viscosity_pair`, `generate_training_data`); the loss is the
masked MSE over those sites, and the optimiser is Adam (AdamW with a
weight decay), optax's ``adam`` / ``adamw`` with their defaults.  A
training step runs its forward and its backward under
``unet3d.precise_flags`` (cuDNN deterministic, no autotuning, TF32 off),
and the pooling's backward is a gather, so on the card a step repeats
bitwise.  ``models/train_unet_prod.py`` is the capture -> train -> eval
pipeline at the flagship.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.models.features import _FACE_PARITY, _embed, build_unet_input, padded_box
from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D, precise_flags

# optax's adam / adamw defaults
BETAS = (0.9, 0.999)
EPS = 1e-8
# Flax's lecun_normal: a normal truncated at +-2 standard deviations,
# scaled so the truncated draw has std sqrt(1 / fan_in)
TRUNC_STD = 0.87962566103423978


class ViscosityExample(NamedTuple):
    """One training pair: features, parity-embedded Δv target and mask."""

    x: torch.Tensor  # (1, 11, D, H, W)
    y: torch.Tensor  # (1, 3, D, H, W) Δv·(1/dt) at the face parities
    mask: torch.Tensor  # (1, 3, D, H, W) 1 at the face parities


def capture_viscosity_pair(gv_before, gv_after, sphi, lvol, cfg) -> ViscosityExample:
    """(features, target) from the velocities around the viscosity solve."""
    data_size, pad = padded_box(tuple(sphi.shape))
    x = build_unet_input(gv_before, sphi, lvol, cfg.grid.dx**3)
    inv_dt = float(int(round(1.0 / cfg.physics.dt)))
    chans, masks = [], []
    for a in range(3):
        dv = (gv_after[a] - gv_before[a]) * inv_dt
        chans.append(_embed(dv, data_size, pad, _FACE_PARITY[a]))
        masks.append(_embed(torch.ones_like(dv), data_size, pad, _FACE_PARITY[a]))
    return ViscosityExample(x=x, y=torch.stack(chans)[None], mask=torch.stack(masks)[None])


def masked_mse(pred, target, mask):
    """Loss on the face-parity sites only (the other lattice sites are
    padding): sum((pred - target)^2 * mask) / max(sum(mask), 1)."""
    se = (pred - target) ** 2 * mask
    return torch.sum(se) / torch.clamp(torch.sum(mask), min=1.0)


class TrainState(NamedTuple):
    """The model's parameters (the live tensors), the optimiser holding
    their Adam moments, and the steps taken."""

    params: Dict[str, torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int


def flax_fan_in(name: str, weight: torch.Tensor) -> int:
    """fan_in of a UNet3D weight counted in Flax's kernel layout (kD, kH,
    kW, I, O): 27 I for a conv, 8 I for an unpool (a transposed conv's
    weight is (I, O, k, k, k)), I for the 1x1x1 ``fc``."""
    taps = math.prod(weight.shape[2:])
    return taps * (weight.shape[0] if name.startswith("unpool") else weight.shape[1])


def lecun_init_(model: UNet3D, generator: torch.Generator) -> None:
    """Flax's initialisation of the JAX ``UNet3D``: kernels
    ``lecun_normal`` (std sqrt(1 / fan_in) / TRUNC_STD, cut at +-2 std),
    biases zero.  Drawn on the CPU ``generator`` and copied to the
    model's device, so a seed gives the same weights on every device."""
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith(".bias"):
                p.zero_()
                continue
            std = math.sqrt(1.0 / flax_fan_in(key.split(".")[0], p)) / TRUNC_STD
            w = torch.empty(p.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(w * std)


def make_trainer(model: UNet3D, lr: float = 1e-4, weight_decay: float = 0.0):
    """(init, train_step) for `model`: Adam at `lr`, AdamW when
    `weight_decay` is set (decaying every parameter, as optax's adamw).

    ``init(generator, example_x)`` draws the parameters (`lecun_init_`)
    and starts the optimiser; ``train_step(ts, ex)`` takes one step on the
    pair `ex` and returns ``(ts, loss)`` (the loss a 0-d tensor on the
    model's device, before the update)."""

    def init(generator: torch.Generator, example_x: torch.Tensor) -> TrainState:
        in_channels = model.enc1_1[0].in_channels
        if example_x.ndim != 5 or example_x.shape[1] != in_channels:
            raise ValueError(f"make_trainer: example_x {tuple(example_x.shape)}, expected (N, {in_channels}, D, H, W)")
        lecun_init_(model, generator)
        params = dict(model.named_parameters())
        if weight_decay:
            opt = torch.optim.AdamW(params.values(), lr=lr, betas=BETAS, eps=EPS, weight_decay=weight_decay)
        else:
            opt = torch.optim.Adam(params.values(), lr=lr, betas=BETAS, eps=EPS)
        return TrainState(params, opt, 0)

    def train_step(ts: TrainState, ex: ViscosityExample) -> Tuple[TrainState, torch.Tensor]:
        ts.optimizer.zero_grad(set_to_none=True)
        with precise_flags():  # the backward's convolutions too
            loss = masked_mse(model(ex.x), ex.y, ex.mask)
            loss.backward()
        ts.optimizer.step()
        return ts._replace(step=ts.step + 1), loss.detach()

    return init, train_step


def train(
    model: UNet3D,
    examples: Iterator[ViscosityExample],
    num_steps: int,
    lr: float = 1e-4,
    seed: int = 0,
    log_every: int = 50,
) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Minimal offline loop from the trainer's init (``torch.Generator``
    seeded `seed`); returns (state_dict, loss history).  Save it as the
    reference does, ``torch.save({"net": state_dict}, path)``: both
    ``convert.load_reference_checkpoint`` and the JAX package's
    ``load_torch_checkpoint`` read that."""
    init, train_step = make_trainer(model, lr)
    first = next(examples)
    ts = init(torch.Generator().manual_seed(seed), first.x)
    losses: List[float] = []
    ex = first
    for k in range(num_steps):
        ts, loss = train_step(ts, ex)
        losses.append(float(loss))
        if (k + 1) % log_every == 0:
            print(f"train step {k + 1}: loss {np.mean(losses[-log_every:]):.3e}")
        try:
            ex = next(examples)
        except StopIteration:
            break
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, losses


def generate_training_data(state, cfg, num_steps: int) -> Iterator[ViscosityExample]:
    """Run the classical ('apic') engine capturing one training pair a
    step (``step_3d(..., capture_ml=True)``), the static geometry built
    once as ``simulate`` does; yields a ViscosityExample a step while the
    state advances."""
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d

    geom = build_geom_cache(state.solid)
    for _ in range(num_steps):
        state, metrics = step_3d(state, cfg, geom=geom, capture_ml=True)
        yield metrics["ml_pair"]

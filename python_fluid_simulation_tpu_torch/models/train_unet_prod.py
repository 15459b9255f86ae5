"""The full-width learned viscosity operator: capture -> train -> eval
(counterpart of the JAX package's ``benchmarks/train_unet_prod.py``).

  capture   run the classical ('apic') engine on the flagship buckling
            scene at a fixed dt, saving the raw fields around each
            viscosity solve (``step_3d(capture_ml="raw")``) as one .npz a
            step (the JAX script's keys and dtypes), and the solid level
            set as sphi.npy.
  train     the UNet3D (width 64: 68,723,203 parameters) from the
            trainer's init, bf16 compute and fp32 parameters, batch 1 over
            the pairs in a ``numpy.random.default_rng(0)`` permutation an
            epoch; a checkpoint an epoch, ``torch.save({"net":
            state_dict})`` (the reference's format), and the loss curve.
  eval      'apic' (ground truth), 'unet' (the network in place of the
            viscosity solve) and 'unet_warm' (the solve started from the
            network's guess) from the same scene state: the per-step
            fluid-surface IoU (lphi < 0) of 'unet' against 'apic' and the
            warm start's viscosity iterations; writes metrics.json with
            the JAX script's keys and prints the bar of the banked JAX
            operator (``tests/test_unet_prod.py``) as met or missed.

    python3 -m python_fluid_simulation_tpu_torch.models.train_unet_prod capture --steps 300
    python3 -m python_fluid_simulation_tpu_torch.models.train_unet_prod train --epochs 12
    python3 -m python_fluid_simulation_tpu_torch.models.train_unet_prod eval --steps 120

Everything is written under ``--out`` (default ``unet_prod_torch/`` at
the repository's root); ``--device`` defaults to ``cuda``.  The
functions also take ``dx``, a coarser scene (the CPU tests'; all three
must be given the same).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "unet_prod_torch")
DX = 0.0125  # the flagship's
# the banked JAX operator's bar (tests/test_unet_prod.py:53-69)
BAR_STEPS = 100
BAR_IOU_FIRST_60 = 0.97  # min of iou_series_every_10[:6]
BAR_IOU_MIN = 0.90


def _cfg(dx: float = DX):
    """The flagship 'apic' config at a fixed dt: the captured targets are
    scaled by 1/DT (``capture_viscosity_pair``), and the reference's unet
    mode always steps at DT (cell 13 :4572-4576), so train and eval use
    one dt."""
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config

    return buckling_config(dx=dx, mu=1.0, viscosity_mode="apic", dt_mode="fixed")


def _paths(out: str):
    return dict(data=os.path.join(out, "pairs"), sphi=os.path.join(out, "sphi.npy"),
                losses=os.path.join(out, "loss_curve.npy"), metrics=os.path.join(out, "metrics.json"))


def ckpt_path(out: str, width: int) -> str:
    return os.path.join(out, f"unet_width{width}.pt")


def capture(steps: int, out: str = OUT, dx: float = DX, device: str = "cuda") -> None:
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d

    paths = _paths(out)
    os.makedirs(paths["data"], exist_ok=True)
    cfg = _cfg(dx)
    state = buckling_scene(cfg, device=device)
    geom = build_geom_cache(state.solid)
    np.save(paths["sphi"], state.solid.phi.cpu().numpy())
    t0 = time.perf_counter()
    for k in range(steps):
        state, metrics = step_3d(state, cfg, geom=geom, capture_ml="raw")
        pair = metrics["ml_pair"]
        gvb = [v.cpu().numpy().astype(np.float32) for v in pair["gv_before"]]
        dv = [a.cpu().numpy().astype(np.float32) - b for a, b in zip(pair["gv_after"], gvb)]
        np.savez(
            os.path.join(paths["data"], f"pair_{k:04d}.npz"),
            gvx=gvb[0], gvy=gvb[1], gvz=gvb[2], dvx=dv[0], dvy=dv[1], dvz=dv[2],
            lvol=pair["lvol"].cpu().numpy().astype(np.float16),
            visc_iters=metrics["viscosity_iters"].cpu().numpy(),
        )
        if (k + 1) % 25 == 0:
            print(f"captured {k + 1}/{steps} ({(time.perf_counter() - t0) / (k + 1) * 1e3:.0f} ms/step)", flush=True)
    print(f"done: {steps} pairs in {paths['data']}", flush=True)


def load_pair(path: str, sphi: torch.Tensor, cfg):
    """The ViscosityExample of a captured .npz, on the device of `sphi`."""
    from python_fluid_simulation_tpu_torch.models.train import capture_viscosity_pair

    z = np.load(path)
    dev = sphi.device
    gvb = tuple(torch.from_numpy(z[k]).to(dev) for k in ("gvx", "gvy", "gvz"))
    gva = tuple(torch.from_numpy(z["gv" + a] + z["dv" + a]).to(dev) for a in ("x", "y", "z"))
    lvol = torch.from_numpy(z["lvol"].astype(np.float32)).to(dev)
    return capture_viscosity_pair(gvb, gva, sphi, lvol, cfg)


def pair_files(out: str, steps_cap: int | None = None) -> list:
    data = _paths(out)["data"]
    files = sorted(os.path.join(data, f) for f in os.listdir(data) if f.startswith("pair_"))
    return files[:steps_cap] if steps_cap else files


def train(epochs: int, lr: float = 1e-4, width: int = 64, resume: bool = False, steps_cap: int | None = None,
          out: str = OUT, dx: float = DX, device: str = "cuda") -> list:
    """Returns the loss of every step."""
    from python_fluid_simulation_tpu_torch.convert import load_reference_checkpoint
    from python_fluid_simulation_tpu_torch.models.train import make_trainer
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    paths = _paths(out)
    cfg = _cfg(dx)
    sphi = torch.from_numpy(np.load(paths["sphi"])).to(device)
    files = pair_files(out, steps_cap)
    if not files:
        raise FileNotFoundError(f"no pairs in {paths['data']}: run `capture` first")
    print(f"{len(files)} pairs, width={width}, epochs={epochs}", flush=True)

    model = UNet3D(width=width, dtype=torch.bfloat16).to(device)
    init, train_step = make_trainer(model, lr)
    ts = init(torch.Generator().manual_seed(0), load_pair(files[0], sphi, cfg).x)
    ckpt = ckpt_path(out, width)
    if resume and os.path.exists(ckpt):  # the parameters carry over, Adam starts afresh (as the JAX script)
        model.load_state_dict(load_reference_checkpoint(ckpt))
        print("resumed from", ckpt, flush=True)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M", flush=True)

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for ep in range(epochs):
        for j in rng.permutation(len(files)):
            ts, loss = train_step(ts, load_pair(files[j], sphi, cfg))
            losses.append(float(loss))
            if len(losses) % 50 == 0:
                print(f"ep {ep} it {len(losses)}: loss {np.mean(losses[-50:]):.4e}"
                      f" ({(time.perf_counter() - t0) / len(losses) * 1e3:.0f} ms/it)", flush=True)
        torch.save({"net": model.state_dict()}, ckpt)
        np.save(paths["losses"], np.asarray(losses))
        print(f"epoch {ep}: mean loss {np.mean(losses[-len(files):]):.4e}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("saved", ckpt, flush=True)
    return losses


def surface_iou(a_phi: torch.Tensor, b_phi: torch.Tensor) -> float:
    a, b = a_phi < 0, b_phi < 0
    return float((a & b).sum()) / max(1, int((a | b).sum()))


def load_model(width: int = 64, out: str = OUT, device: str = "cuda"):
    """The trained operator, bf16 compute (the JAX script's eval model)."""
    from python_fluid_simulation_tpu_torch.convert import load_reference_checkpoint
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    model = UNet3D(width=width, dtype=torch.bfloat16).eval()
    model.load_state_dict(load_reference_checkpoint(ckpt_path(out, width)))
    return model.to(device)


def bars(rec: dict) -> dict:
    """The banked JAX operator's bar, each part met or not."""
    return {
        f"steps >= {BAR_STEPS}": rec["steps"] >= BAR_STEPS,
        f"min(iou_series_every_10[:6]) >= {BAR_IOU_FIRST_60}": min(rec["iou_series_every_10"][:6]) >= BAR_IOU_FIRST_60,
        f"iou_min >= {BAR_IOU_MIN}": rec["iou_min"] >= BAR_IOU_MIN,
    }


def evaluate(steps: int, width: int = 64, out: str = OUT, dx: float = DX, device: str = "cuda"):
    """Returns (metrics.json's record, the per-step series: the IoU and
    the viscosity iterations of 'apic' and 'unet_warm')."""
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset

    cfg = _cfg(dx)
    model = load_model(width, out, device)
    g = cfg.grid

    def run(mode):
        c = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode=mode))
        state = buckling_scene(c, device=device)
        geom = build_geom_cache(state.solid)
        net = model if mode != "apic" else None
        phis, iters = [], []
        for _ in range(steps):
            state, metrics = step_3d(state, c, geom=geom, unet=net)
            p = state.particles
            phis.append(compute_fluid_levelset(p.x, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m))
            iters.append(int(metrics["viscosity_iters"]))
        return phis, iters

    t0 = time.perf_counter()
    apic_phis, apic_iters = run("apic")
    print(f"apic run: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    unet_phis, _ = run("unet")
    print(f"unet run: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    _, warm_iters = run("unet_warm")
    print(f"warm run: {time.perf_counter() - t0:.1f}s", flush=True)

    ious = [surface_iou(a, u) for a, u in zip(apic_phis, unet_phis)]
    print("iou per step:", json.dumps([round(v, 4) for v in ious]), flush=True)
    print("viscosity iterations, apic:", apic_iters, flush=True)
    print("viscosity iterations, unet_warm:", warm_iters, flush=True)
    rec = {
        "steps": steps,
        "grid": list(g.res),
        "width": width,
        "iou_series_every_10": [round(v, 4) for v in ious[::10]],
        "iou_final": round(ious[-1], 4),
        "iou_min": round(min(ious), 4),
        "apic_visc_iters_mean": float(np.mean(apic_iters)),
        "warm_visc_iters_mean": float(np.mean(warm_iters)),
        "warm_iter_cut": float(np.mean(apic_iters) - np.mean(warm_iters)),
    }
    os.makedirs(out, exist_ok=True)
    with open(_paths(out)["metrics"], "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    for bar, met in bars(rec).items():
        print(f"bar {bar}: {'met' if met else 'missed'}", flush=True)
    return rec, dict(iou=ious, apic_visc_iters=apic_iters, warm_visc_iters=warm_iters)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("--steps", type=int, default=300)
    t = sub.add_parser("train")
    t.add_argument("--epochs", type=int, default=12)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--width", type=int, default=64)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--steps-cap", type=int, default=None)
    e = sub.add_parser("eval")
    e.add_argument("--steps", type=int, default=120)
    e.add_argument("--width", type=int, default=64)
    for s in (c, t, e):
        s.add_argument("--out", default=OUT)
        s.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    where = dict(out=args.out, device=args.device)
    if args.cmd == "capture":
        capture(args.steps, **where)
    elif args.cmd == "train":
        train(args.epochs, args.lr, args.width, args.resume, args.steps_cap, **where)
    else:
        evaluate(args.steps, args.width, **where)


if __name__ == "__main__":
    main()

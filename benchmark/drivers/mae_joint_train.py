"""mae_joint_train: the OCTCube joint pretraining step in a closed loop of
back-to-back steps: each step one batch of 3D volumes (mask
``mask_ratio``, the blank-region pre-mask computed inside the step) and
one batch of 2D high-res images (mask ``mask_ratio_2d``) through
``mae_engine.make_mae_train_step(joint=True, use_premask=True)``, the two
losses summed (``configs/octcube_vitl16_joint.py`` builds it).

The cell's ``traffic``: a pool of ``pool`` distinct seeded (volumes,
images) batches held in pinned host memory and copied to the card each
step, as a loader would; the masking noise of both batches drawn each
step from the seed and passed to the step as ``noise=``.  The volumes
are ``training.volumes``' seeded noise, each B-scan with a constant band
at the sample's offset over patch rows 3-7 (``BAND``): the empty
vitreous above the retina, which the pre-mask should find.  A 2D image
is one seeded B-scan repeated over a tube of ``t_patch_size`` frames,
as the pretraining loader makes it.

Set-up builds the one train state the window uses and drives it through
its first ``follow_steps`` steps (warm-up, capture, replay where the step
replays a graph), through the window's own feed and call.  Read from
them: the losses (summed, 3D, 2D), the volumes' per-frame losses, the
pre-mask each step computed (the program's ``compute_premask`` wrapped
for those steps), the first gradient as the optimizer holds it and every
leaf's change after the last step.  Once the window has closed the plain
reference (``reference/mae_joint.py``) follows the same steps from the
same weights, batches and noise in float32, given the program's pre-mask
(its top-up picks lie on near-ties that bfloat16 and float32 can order
differently), and computes its own pre-mask beside it, which is held
against the program's apart: the share of patches on which the two
differ, and the band's patches on which they differ.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import training, weights
from reference import adamw, mae_joint, plain, vit3d

BAND = (3, 8)   # patch rows [3, 8) of the blank band


def pool_batches(run, g: dict, count: int):
    """The pool's batches {"x": volumes, "x2d": images}, made on the
    device from the seed."""
    dev, p = run.device, g["patch_size"]
    gen = torch.Generator(device=dev).manual_seed(run.seed_for("data"))
    n, s = g["batch"], g["input_size"]
    shape = (n, g["num_frames"], s, s, g["in_chans"])
    rest = (1,) * (len(shape) - 1)
    for _ in range(count):
        lo = 0.3 * torch.rand((n, *rest), generator=gen, device=dev)
        span = 0.3 + 0.7 * torch.rand((n, *rest), generator=gen, device=dev)
        x = lo + span * torch.rand(shape, generator=gen, device=dev)
        x[:, :, BAND[0] * p:BAND[1] * p] = lo
        hs = g["high_res_input_size"]
        img = training.volumes((g["batch2d"], 1, hs, hs, g["in_chans"]),
                               gen, dev)
        yield {"x": x, "x2d": img.expand(-1, g["t_patch_size"], -1, -1, -1)
               .contiguous()}


@contextlib.contextmanager
def program_premask():
    """Within the block, each pre-mask the step computes is kept as
    ``box.last`` (a replay refreshes the tensor its capture made)."""
    from octcubem_tpu_torch.train import mae_engine

    orig = mae_engine.compute_premask
    box = type("Box", (), {"last": None})()

    def kept(*args, **kw):
        box.last = orig(*args, **kw)
        return box.last

    mae_engine.compute_premask = kept
    try:
        yield box
    finally:
        mae_engine.compute_premask = orig


class Program:
    """The program's side of a run: the built step, its feed and what set-up
    read from its state."""

    def __init__(self, run):
        tr, dev = run.traffic, run.device
        self.pool_n, self.follow = tr["pool"], tr["follow_steps"]
        self.wseed = run.seed_for("weights")
        step, state, g = run.cfgmod.build_joint_train(
            run.config, dev, self.wseed, run.overrides)
        self.geom = g
        self.step, self.state = step, state
        self.model, self.tx = state.params, state.tx
        training.check_optimizer(self.tx, run.config["optimizer"])
        self.pool = training.host_pool(lambda b: b, self.pool_n, dev,
                                       pool_batches(run, g, self.pool_n))
        tp, p = g["t_patch_size"], g["patch_size"]
        self.tokens = ((g["num_frames"] // tp) * (g["input_size"] // p) ** 2,
                       (g["high_res_input_size"] // p) ** 2)
        self.ngen = torch.Generator(device=dev).manual_seed(
            run.seed_for("noise"))
        self.dev = dev
        self.metrics = None

    def feed(self, i: int) -> dict:
        g = self.geom
        b = training.to_device(self.pool[i % self.pool_n], self.dev)
        b["noise"] = [torch.rand((n, t), generator=self.ngen, device=self.dev)
                      for n, t in zip((g["batch"], g["batch2d"]), self.tokens)]
        return b

    def call(self, b):
        g = self.geom
        self.state, self.metrics = self.step(
            self.state, b["x"], g["mask_ratio"], batch2d=b["x2d"],
            mask_ratio_2d=g["mask_ratio_2d"], noise=b["noise"])
        return self.metrics["loss"]

    def follow_steps(self) -> dict:
        """Set-up's first steps -> the program's readings; the noise and the
        pre-masks they used are kept for the reference."""
        tx, grad, noises, premasks, read = self.tx, None, [], [], []
        with program_premask() as box:
            for i in range(self.follow):
                b = self.feed(i)
                noises.append([n.clone() for n in b["noise"]])
                self.call(b)
                premasks.append(box.last.clone())
                read.append({k: self.metrics[k] for k in (
                    "loss", "loss_3d", "loss_2d", "frame_losses")})
                if i == 0:
                    grad = training.leaf_norms(
                        [m.float() / (1.0 - tx.b1) for m in tx.mu], tx.names)
            box.last = None
        named = dict(self.model.named_parameters())
        w0 = weights.make(weights.specs_of(self.model), self.wseed, self.dev)
        delta = {n: (named[n].detach() - w0[n]).cpu() for n in named}
        del w0
        self.noises, self.premasks = noises, premasks
        return {"losses": [float(r["loss"]) for r in read],
                "loss_3d": [float(r["loss_3d"]) for r in read],
                "loss_2d": [float(r["loss_2d"]) for r in read],
                "frame_losses": [r["frame_losses"].float().cpu() for r in read],
                "premask": [m.cpu() for m in premasks],
                "grad": grad, "delta": delta}

    def free(self) -> None:
        for k in ("step", "state", "model", "tx", "metrics"):
            setattr(self, k, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(run, prog: Program, precision: str = "fp32",
                       rows2d=None) -> dict:
    """The plain reference through the followed steps, from the same
    weights, batches, noise and pre-masks: its losses, per-frame losses,
    own pre-masks, its first gradient's leaf norms and the entries it
    moves, and its change after the last step."""
    plain.no_tf32()
    c, dev = prog.geom, run.device
    p = weights.make(vit3d.mae_specs(c), prog.wseed, dev)
    for t in p.values():
        t.requires_grad_(True)
    init = {n: t.detach().clone() for n, t in p.items()}
    opt = adamw.AdamW(p, run.config["optimizer"])
    P = plain.Precision(precision)
    out = {k: [] for k in ("losses", "loss_3d", "loss_2d", "frame_losses",
                           "premask")}
    for s in range(prog.follow):
        b = prog.pool[s % prog.pool_n]
        vol, imgs = b["x"].to(dev), b["x2d"].to(dev)
        n3, n2 = prog.noises[s]
        with torch.no_grad():
            out["premask"].append(mae_joint.premask(p, c, vol, P).cpu())
        r, grads = mae_joint.joint_loss_and_grads(
            p, c, vol, n3, prog.premasks[s], imgs, n2, P, rows2d)
        out["losses"].append(r["loss"])
        out["loss_3d"].append(r["loss_3d"])
        out["loss_2d"].append(r["loss_2d"])
        out["frame_losses"].append(r["frame_losses"].cpu())
        if s == 0:
            out["grad"] = training.leaf_norms(list(grads.values()),
                                              list(grads))
            out["keep"] = training.moving_entries(grads)
        opt.step(grads)
        del grads, vol, imgs
    out["delta"] = {n: p[n].detach() - init[n] for n in p}
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if a == a else float("inf")


def _band(grid: int, tokens: int):
    """[tokens] bool: the band's patches of every frame."""
    row = (torch.arange(tokens) % (grid * grid)) // grid
    return (row >= BAND[0]) & (row < BAND[1])


def gaps(side: dict, ref: dict, grid: int, device) -> dict:
    """``training.gaps`` (the summed loss, the first gradient, the change)
    and the joint step's own numbers: the largest relative gap of a step's
    3D and 2D loss (``loss_3d_gap``, ``loss_2d_gap``) and of a volume's
    frame loss (``frame_loss_gap``); the patches on which the two
    pre-masks differ, over those the reference's forces
    (``premask_gap``); and the band's patches on which they differ
    (``premask_band_gap``, a count)."""
    g = training.gaps(side, ref, device)
    for k in ("loss_3d", "loss_2d"):
        g[f"{k}_gap"] = max(_rel(a, b) for a, b in zip(side[k], ref[k]))
    g["frame_loss_gap"] = max(
        float(((a - b).abs() / b.abs()).nan_to_num(float("inf")).max())
        for a, b in zip(side["frame_losses"], ref["frame_losses"]))
    diff = forced = band = 0
    for a, b in zip(side["premask"], ref["premask"]):
        d = (a > 0) != (b > 0)
        diff += int(d.sum())
        forced += int((b > 0).sum())
        band += int(d[:, _band(grid, d.shape[1])].sum())
    g["premask_gap"] = diff / max(forced, 1)
    g["premask_band_gap"] = float(band)
    return g


def band_forced(masks, grid: int) -> str:
    """How many of the followed volumes had every band patch forced."""
    full = [bool((m > 0)[i, _band(grid, m.shape[1])].all())
            for m in masks for i in range(m.shape[0])]
    return f"{sum(full)} of {len(full)}"


def compare(run, prog: Program, ours: dict, ref: dict) -> None:
    grid = prog.geom["input_size"] // prog.geom["patch_size"]
    g = gaps(ours, ref, grid, run.device)
    run.note(f"worst leaves: first gradient {g['grad_leaf']}, change "
             f"{g['change_leaf']}; {training.left_out(ref['keep'])}")
    run.note(f"losses: program {ours['losses']}, reference {ref['losses']}; "
             f"3D {ours['loss_3d']} / {ref['loss_3d']}; 2D {ours['loss_2d']}"
             f" / {ref['loss_2d']}")
    run.note(f"volumes with the whole band forced: program "
             f"{band_forced(ours['premask'], grid)}, reference "
             f"{band_forced(ref['premask'], grid)}")
    run.note("gaps: " + ", ".join(f"{k} {v!r}" for k, v in g.items()
                                  if not k.endswith("_leaf")))
    for k, lim in run.workload["limits"].items():
        run.check(k, g[k], lim)


def calibrate(run, controls=()) -> list:
    """Readings for the limits: the program against the reference, and
    those named in ``controls``: ``control_fp8`` (the reference in the
    program's place, its products in float8) and ``fault_half_batch``
    (the reference with half of the 2D images left out, the mean taken
    over the rest)."""
    prog = Program(run)
    ours = prog.follow_steps()
    prog.free()
    ref = reference_readings(run, prog)
    grid = prog.geom["input_size"] // prog.geom["patch_size"]
    out = [{"reading": "program", **gaps(ours, ref, grid, run.device)}]
    del ours
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch",
                      {"rows2d": range(prog.geom["batch2d"] // 2)})):
        if name in controls:
            out.append({"reading": name, **gaps(
                reference_readings(run, prog, **kw), ref, grid, run.device)})
    return out


def run(run) -> None:
    import octcubem_tpu_torch.nn.layers as layers

    prog = Program(run)
    ours = prog.follow_steps()
    start = prog.follow
    training.measure_window(run, lambda i: prog.feed(start + i), prog.call,
                            prog.geom["batch"])
    run.window["flops"] = (run.cfgmod.flops_per_step(prog.geom)
                           * run.window["steps"])
    if run.trace:
        training.stretch(run, lambda i: prog.feed(i), prog.call, prog.tx,
                         layers, run.traffic["trace_steps"],
                         start=start + run.window["steps"])
    prog.free()
    run.check("failed_steps", run.failed, 0)
    t = time.perf_counter()
    ref = reference_readings(run, prog)
    run.note(f"reference: {time.perf_counter() - t:.1f} s for "
             f"{prog.follow} steps")
    compare(run, prog, ours, ref)

"""mae_train: the 3D MAE pretraining step in a closed loop of back-to-back
steps (``entry.train_entry``'s ``mae_engine.make_mae_train_step`` with
the fused AdamW).

The cell's ``traffic``: ``batch`` volumes a step, drawn from a pool of
``pool`` distinct seeded batches held in pinned host memory and copied
to the card each step; the masking noise drawn each step from the seed
and passed to the step as ``noise=``.

Set-up builds the one train state the window uses and drives it from the
seed through its first ``follow_steps`` steps, through the window's own
feed and call, on pool batches whose rows all differ.  Their losses, the
first gradient as the optimizer holds it after step 1 (its first moment
over 1 - beta1) and the change of every leaf after the last of them (kept
on the host) are read and held against the plain reference
(``reference/vit3d.py``), which follows the same steps from the same
weights, batches and noise in float32 once the window has closed.  The
change is compared over the entries that the reference's first gradient
moves (``training.moving_entries``).
"""

from __future__ import annotations

import time

import torch

from harness import training, weights
from reference import adamw, plain, vit3d


def pool_batches(run, shape, count: int):
    """The pool's batches, made on the device from the seed."""
    gen = torch.Generator(device=run.device).manual_seed(run.seed_for("data"))
    for _ in range(count):
        yield training.volumes(shape, gen, run.device)


class Program:
    """The program's side of a run: the built step, its feed and what set-up
    read from its state."""

    def __init__(self, run):
        tr, dev = run.traffic, run.device
        self.batch, self.pool_n = tr["batch"], tr["pool"]
        self.follow = tr["follow_steps"]
        self.wseed = run.seed_for("weights")
        step, state, g = run.cfgmod.build_mae_train(
            run.config, dev, self.wseed, self.batch, run.overrides)
        self.geom, self.mask = g, g["mask_ratio"]
        self.step, self.state = step, state
        self.model, self.tx = state.params, state.tx
        training.check_optimizer(self.tx, run.config["optimizer"])
        shape = (self.batch, g["num_frames"], g["input_size"],
                 g["input_size"], g["in_chans"])
        self.shape = shape
        self.pool = training.host_pool(
            lambda b: {"x": b}, self.pool_n, dev,
            pool_batches(run, shape, self.pool_n))
        self.tokens = (g["num_frames"] // g["t_patch_size"]) * (
            g["input_size"] // g["patch_size"]) ** 2
        self.ngen = torch.Generator(device=dev).manual_seed(
            run.seed_for("noise"))
        self.dev = dev

    def feed(self, i: int) -> dict:
        b = training.to_device(self.pool[i % self.pool_n], self.dev)
        b["noise"] = torch.rand((self.batch, self.tokens),
                                generator=self.ngen, device=self.dev)
        return b

    def call(self, b):
        self.state, m = self.step(self.state, b["x"], self.mask,
                                  noise=b["noise"])
        return m["loss"]

    def follow_steps(self) -> dict:
        """Set-up's first steps -> the program's readings and the noise
        they used."""
        tx, losses, noises, grad = self.tx, [], [], None
        for i in range(self.follow):
            b = self.feed(i)
            noises.append(b["noise"].clone())
            losses.append(self.call(b))
            if i == 0:
                grad = training.leaf_norms(
                    [m.float() / (1.0 - tx.b1) for m in tx.mu], tx.names)
        named = dict(self.model.named_parameters())
        w0 = weights.make(weights.specs_of(self.model), self.wseed, self.dev)
        delta = {n: (named[n].detach() - w0[n]).cpu() for n in named}
        del w0
        self.noises = noises
        return {"losses": [float(x) for x in losses], "grad": grad,
                "delta": delta}

    def free(self) -> None:
        for k in ("step", "state", "model", "tx"):
            setattr(self, k, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(run, prog: Program, precision: str = "fp32",
                       rows=None) -> dict:
    """The plain reference through the followed steps, from the same
    weights, batches and noise: its losses, its first gradient's leaf
    norms and the entries it moves, and its change after the last
    step."""
    plain.no_tf32()
    c, dev = prog.geom, run.device
    specs = vit3d.mae_specs(c)
    p = weights.make(specs, prog.wseed, dev)
    for t in p.values():
        t.requires_grad_(True)
    init = {n: t.detach().clone() for n, t in p.items()}
    opt = adamw.AdamW(p, run.config["optimizer"])
    P = plain.Precision(precision)
    losses, grad = [], None
    for s in range(prog.follow):
        x = prog.pool[s % prog.pool_n]["x"].to(dev)
        loss, grads = vit3d.mae_loss_and_grads(p, c, x, prog.noises[s],
                                               prog.mask, P, rows)
        if s == 0:
            grad = training.leaf_norms(list(grads.values()), list(grads))
            keep = training.moving_entries(grads)
        opt.step(grads)
        losses.append(loss)
        del grads
    delta = {n: p[n].detach() - init[n] for n in p}
    return {"losses": losses, "grad": grad, "delta": delta, "keep": keep}


def calibrate(run, controls=()) -> list:
    """Readings for the limits: the program against the reference, and
    those named in ``controls``: ``control_fp8`` (the reference in the
    program's place, its products in float8) and ``fault_half_batch``
    (the reference with half of each batch left out, the mean taken over
    the rest)."""
    prog = Program(run)
    ours = prog.follow_steps()
    prog.free()
    ref = reference_readings(run, prog)
    out = [{"reading": "program", **training.gaps(ours, ref, run.device)}]
    del ours
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"rows": range(prog.batch // 2)})):
        if name in controls:
            out.append({"reading": name, **training.gaps(
                reference_readings(run, prog, **kw), ref, run.device)})
    return out


def run(run) -> None:
    import octcubem_tpu_torch.nn.layers as layers

    prog = Program(run)
    ours = prog.follow_steps()
    start = prog.follow
    training.measure_window(run, lambda i: prog.feed(start + i), prog.call,
                            prog.batch)
    run.window["flops"] = (run.cfgmod.mae_flops_per_sample(prog.geom)
                           * run.window["samples"])
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
    training.compare(run, ours, ref)

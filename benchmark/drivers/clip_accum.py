"""clip_accum: the COEM contrastive step with the feature-cached
accumulation (``clip_engine.make_clip_accum_train_step`` on
``models/coem``) in a closed loop of back-to-back steps.

The cell's ``traffic``: steps of ``accum_freq`` chunks of ``chunk``
pairs, each pair a seeded OCT volume and an en face image, drawn from a
pool of ``pool`` distinct seeded batches in pinned host memory and copied
to the card each step.

Set-up builds the one train state the window uses and drives it through
its first ``follow_steps`` steps through the window's own feed and call,
on pool batches whose pairs all differ; their losses, the features of
both towers that the first step's cached pass computes (read by a hook on
the model for that step only), the first gradient as the optimizer holds
it after step 1 and each trainable leaf's change after the last (kept on
the host) are held against the plain reference (``reference/coem.py``),
which follows the same steps from the same weights and pairs in float32
once the window has closed.  The change is compared over the entries
that the reference's first gradient moves (``training.moving_entries``).
"""

from __future__ import annotations

import time

import torch

from harness import training, weights
from reference import adamw, coem, plain


class Program:
    def __init__(self, run):
        tr, dev = run.traffic, run.device
        self.pool_n, self.follow = tr["pool"], tr["follow_steps"]
        self.wseed = run.seed_for("weights")
        step, state, g = run.cfgmod.build_clip_train(
            run.config, dev, self.wseed, run.overrides)
        self.step, self.state, self.geom = step, state, g
        self.model, self.tx = state.params, state.tx
        training.check_optimizer(self.tx, g["optimizer"])
        a, c = g["accum_freq"], g["batch_size"]
        v, e = g["vision_cfg"], g["enface_cfg"]
        shapes = {"image": (a * c, v["num_frames"], v["img_size"],
                            v["img_size"], v["in_chans"]),
                  "enface": (a * c, e["img_size"], e["img_size"],
                             e["in_chans"])}
        dgen = torch.Generator(device=dev).manual_seed(run.seed_for("data"))
        self.pool = training.host_pool(
            lambda i: {k: training.volumes(s, dgen, dev).reshape(a, c, *s[1:])
                       for k, s in shapes.items()}, self.pool_n, dev)
        self.pairs = a * c
        self.fixed = run.cfgmod.FIXED
        self.dev = dev

    def feed(self, i: int) -> dict:
        return training.to_device(self.pool[i % self.pool_n], self.dev)

    def call(self, b):
        self.state, m = self.step(self.state, b)
        return m["loss"]

    def first_step_features(self):
        """The first step, its cached (no-grad) pass's features read ->
        (loss, [OCT, en face] features, chunks in order)."""
        bank = []

        def grab(module, args, out):
            if not torch.is_grad_enabled():
                bank.append([t.detach().float().clone() for t in out[:2]])

        hook = self.model.register_forward_hook(grab)
        try:
            loss = self.call(self.feed(0))
        finally:
            hook.remove()
        return loss, [torch.cat(f) for f in zip(*bank)]

    def follow_steps(self) -> dict:
        tx = self.tx
        loss, features = self.first_step_features()
        grad = training.leaf_norms(
            [m.float() / (1.0 - tx.b1) for m in tx.mu], tx.names)
        losses = [loss] + [self.call(self.feed(i))
                           for i in range(1, self.follow)]
        named = dict(zip(tx.names, tx.params))
        w0 = weights.make(weights.specs_of(self.model), self.wseed, self.dev,
                          self.fixed)
        delta = {n: (named[n].detach() - w0[n]).cpu() for n in named}
        del w0
        return {"losses": [float(x) for x in losses], "grad": grad,
                "delta": delta, "features": features}

    def free(self) -> None:
        for k in ("step", "state", "model", "tx"):
            setattr(self, k, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(run, prog: Program, precision: str = "fp32",
                       rows=None) -> dict:
    plain.no_tf32()
    g, dev = prog.geom, run.device
    p = weights.make(coem.specs(g), prog.wseed, dev, prog.fixed)
    depth, unlocked = g["vision_cfg"]["depth"], g["lock_unlocked_groups"]
    train = {n: t for n, t in p.items()
             if coem.trainable(n, depth, unlocked)}
    for t in train.values():
        t.requires_grad_(True)
    init = {n: t.detach().clone() for n, t in train.items()}
    opt = adamw.AdamW(train, g["optimizer"])
    P = plain.Precision(precision)
    losses, grad, features = [], None, []
    for s in range(prog.follow):
        b = training.to_device(prog.pool[s % prog.pool_n], dev)
        loss, grads = coem.accum_loss_and_grads(
            p, g, b["image"], b["enface"], P, rows,
            banks=features if s == 0 else None)
        del b
        if s == 0:
            grad = training.leaf_norms(list(grads.values()), list(grads))
            keep = training.moving_entries(grads)
        opt.step(grads)
        losses.append(loss)
        del grads
    delta = {n: train[n].detach() - init[n] for n in train}
    return {"losses": losses, "grad": grad, "delta": delta, "keep": keep,
            "features": features}


def calibrate(run, controls=()) -> list:
    """As ``mae_train.calibrate``: the program, and with ``controls`` the
    float8 control and the half-batch fault, each against the reference."""
    prog = Program(run)
    ours = prog.follow_steps()
    prog.free()
    ref = reference_readings(run, prog)
    out = [{"reading": "program", **training.gaps(ours, ref, run.device)}]
    del ours
    chunk = prog.geom["batch_size"]
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"rows": range(chunk // 2)})):
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
                            prog.pairs)
    run.window["flops"] = (run.cfgmod.flops_per_pair(prog.geom)
                           * run.window["samples"])
    if run.trace:
        training.stretch(run, prog.feed, prog.call, prog.tx, layers,
                         run.traffic["trace_steps"],
                         start=start + run.window["steps"])
    prog.free()
    run.check("failed_steps", run.failed, 0)
    t = time.perf_counter()
    ref = reference_readings(run, prog)
    run.note(f"reference: {time.perf_counter() - t:.1f} s for "
             f"{prog.follow} steps")
    training.compare(run, ours, ref)

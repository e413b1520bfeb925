"""mae_train_dp: the 3D MAE pretraining step data-parallel over ranks, one
rank a card, in a closed loop of back-to-back steps
(``mae_engine.make_mae_train_step(mesh=...)`` on a data mesh over all
ranks, NCCL on the cards, gloo on CPU ranks).

The cell's ``traffic``: ``batch`` volumes a rank a step, drawn from each
rank's pool of ``pool`` distinct batches made from the seed and the rank,
held in pinned host memory and copied to the card each step.  No noise
is passed: each step draws the engine's global noise from the replicated
generator, and each rank masks with its rows of it.

Rank 0 runs in the run's process and drives; ranks 1 .. chips - 1 are
processes of this file (``python mae_train_dp.py --worker JSON``),
started by rank 0, which meet it over a ``TCPStore`` on localhost.  Each
builds the same state from the seed and runs what rank 0 posts under
``cmd<i>`` in the store: a step of a given pool index, a reset or a read
of its peak memory, the check of its params, the end.  Rank 0 runs the
measured window (``training.measure_window``) and the profiled stretch,
posting each step before it issues it, so every rank runs the same
steps.  Every rank is torn down whether the run ends or fails.

Set-up drives the state through its first ``follow_steps`` steps.  After
them every rank's params must be bit-equal (``rank_param_mismatch``: the
entries where the ranks' largest and smallest value differ), and rank
0's readings (the global loss, the first gradient as AdamW holds it, the
change of every leaf) are held against the plain reference's one-rank
steps on the global batch with the global noise (``drivers/mae_train.py``'s
``reference_readings``), which the engine's docstring says an n-rank
step equals.  ``samples_per_s`` counts global volumes; ``peak_mem_gib``
reads the fullest rank.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":   # a worker rank: the harness beside this file
    sys.path[:0] = [str(HERE.parents[1]), str(HERE.parent)]

from harness import training, weights  # noqa: E402

TIMEOUT = timedelta(seconds=300)   # a rank waiting on another gives up


def _single_rank_driver():
    """``drivers/mae_train.py``, whose reference readings this cell reuses."""
    name = "bench_driver_mae_train"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name,
                                                      HERE / "mae_train.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def rank_pool(run, shape, rank: int, count: int, device=None):
    """Rank ``rank``'s pool batches, made from the seed and the rank."""
    dev = device or run.device
    gen = torch.Generator(device=dev).manual_seed(
        run.seed_for(f"data.rank{rank}"))
    for _ in range(count):
        yield training.volumes(shape, gen, dev)


class Program:
    """One rank's side: the state, the step over the data mesh, its pool."""

    def __init__(self, run, rank: int, n: int):
        from octcubem_tpu_torch.core import mesh as cmesh
        from octcubem_tpu_torch.train import mae_engine

        tr, dev = run.traffic, run.device
        self.batch, self.pool_n = tr["batch"], tr["pool"]
        self.follow, self.n = tr["follow_steps"], n
        self.wseed = run.seed_for("weights")
        _, state, g = run.cfgmod.build_mae_train(
            run.config, dev, self.wseed, self.batch, run.overrides)
        self.geom, self.mask = g, g["mask_ratio"]
        self.mesh = cmesh.make_mesh(n_data=n, device=dev.type)
        self.state = mae_engine.replicate_state(state, self.mesh)
        self.model, self.tx = state.params, state.tx
        training.check_optimizer(self.tx, run.config["optimizer"])
        self.step = mae_engine.make_mae_train_step(self.model, self.tx,
                                                   mesh=self.mesh)
        self.shape = (self.batch, g["num_frames"], g["input_size"],
                      g["input_size"], g["in_chans"])
        self.pool = training.host_pool(
            lambda b: {"x": b}, self.pool_n, dev,
            rank_pool(run, self.shape, rank, self.pool_n))
        self.tokens = (g["num_frames"] // g["t_patch_size"]) * (
            g["input_size"] // g["patch_size"]) ** 2
        self.dev = dev

    def feed(self, i: int) -> dict:
        return training.to_device(self.pool[i % self.pool_n], self.dev)

    def call(self, b):
        self.state, m = self.step(self.state, b["x"], self.mask)
        return m["loss"]

    def free(self) -> None:
        for k in ("step", "state", "model", "tx"):
            setattr(self, k, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def cpu_shares(n: int) -> list:
    """The CPUs this process may run on as ``n`` equal runs of whole
    physical cores (a core's hyperthreads together), in the order of
    their first CPU: one a rank on the cards, so that no two ranks' host
    threads share a core and every run places them alike (the ranks'
    steps are bound by their host's issue).  Empty runs where there are
    fewer cores than ranks."""
    cores: dict = {}
    for c in sorted(os.sched_getaffinity(0)):
        path = f"/sys/devices/system/cpu/cpu{c}/topology/thread_siblings_list"
        try:
            key = Path(path).read_text().strip()
        except OSError:
            key = str(c)
        cores.setdefault(key, []).append(c)
    groups = sorted(cores.values(), key=lambda g: min(g))
    per = len(groups) // n
    return [[c for g in groups[r * per:(r + 1) * per] for c in g]
            for r in range(n)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(prog: Program) -> int:
    """The largest ``max_memory_allocated`` over the ranks (a collective)."""
    import torch.distributed as dist

    dev = prog.dev
    _sync(dev)
    t = torch.tensor([torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


@torch.no_grad()
def param_mismatch(prog: Program) -> int:
    """Entries of the params on which the ranks differ: where the largest
    and the smallest value over the ranks are not the same bits (a
    collective)."""
    import torch.distributed as dist

    bad = 0
    for p in prog.model.parameters():
        hi, lo = p.detach().clone(), p.detach().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        bad += int((hi.view(torch.int32) != lo.view(torch.int32)).sum())
    return bad


def serve(prog: Program, cmds) -> None:
    """A worker rank: run what rank 0 posts, in order, until ``stop``."""
    i = 0
    while True:
        cmd = cmds.get(f"cmd{i}").decode()
        i += 1
        if cmd.startswith("step:"):
            prog.call(prog.feed(int(cmd[5:])))
        elif cmd == "reset":   # the window starts, as on rank 0
            _sync(prog.dev)
            if prog.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(prog.dev)
            gc.collect()
            gc.freeze()
        elif cmd == "peak":
            peak_bytes(prog)
        elif cmd == "check":
            param_mismatch(prog)
        elif cmd == "stop":
            return
        else:
            raise RuntimeError(f"unknown command {cmd!r}")


class Ranks:
    """Rank 0's view of the group: the store it serves, the workers it
    started, and the commands it posts to them."""

    def __init__(self, run):
        import torch.distributed as dist

        self.n = int(run.chips)
        self.store = dist.TCPStore("127.0.0.1", 0, self.n, is_master=True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        self.cmds = dist.PrefixStore("bench", self.store)
        self.seq = 0
        cpus = (cpu_shares(self.n) if run.device.type == "cuda"
                else [[]] * self.n)
        spec = {"workload": run.name, "seed": run.seed,
                "overrides": run.overrides, "port": self.store.port,
                "n": self.n, "device": run.device.type}
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             json.dumps(dict(spec, rank=r, cpus=cpus[r]))])
            for r in range(1, self.n)]
        self.saved = os.sched_getaffinity(0)
        if cpus[0]:   # this thread and those it starts from here on
            os.sched_setaffinity(0, cpus[0])

    def post(self, cmd: str) -> None:
        self.cmds.set(f"cmd{self.seq}", cmd)
        self.seq += 1

    def join(self) -> None:
        """Every worker ended, each with exit code 0, or raise."""
        codes = [p.wait(timeout=TIMEOUT.total_seconds()) for p in self.procs]
        if any(codes):
            raise RuntimeError(f"worker ranks ended with codes {codes}")

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def release(self) -> None:
        os.sched_setaffinity(0, self.saved)


def _group(store, n: int, rank: int, device_type: str) -> None:
    from octcubem_tpu_torch.core import multihost

    multihost.initialize(store=store, world_size=n, rank=rank,
                         device=device_type,
                         timeout_s=TIMEOUT.total_seconds())


def _follow(run, ranks: Ranks, prog: Program) -> dict:
    """The followed steps on every rank -> rank 0's readings, the global
    noise they drew, and the ranks' param mismatch after them."""
    tx = prog.tx
    gen = torch.Generator(device=prog.dev)
    gen.set_state(prog.state.generator.get_state())
    noises, losses, grad = [], [], None
    for i in range(prog.follow):
        noises.append(torch.rand((prog.batch * prog.n, prog.tokens),
                                 generator=gen, device=prog.dev))
        ranks.post(f"step:{i}")
        losses.append(prog.call(prog.feed(i)))
        if i == 0:
            grad = training.leaf_norms(
                [m.float() / (1.0 - tx.b1) for m in tx.mu], tx.names)
    ranks.post("check")
    mismatch = param_mismatch(prog)
    named = dict(prog.model.named_parameters())
    w0 = weights.make(weights.specs_of(prog.model), prog.wseed, prog.dev)
    delta = {k: (named[k].detach() - w0[k]).cpu() for k in named}
    del w0
    return {"losses": [float(x) for x in losses], "grad": grad,
            "delta": delta, "noises": noises, "mismatch": mismatch}


class GlobalBatch:
    """The one-rank view of the followed steps that the reference takes:
    the ranks' batches side by side and the global noise."""

    def __init__(self, run, prog: Program, noises):
        self.geom, self.wseed, self.mask = prog.geom, prog.wseed, prog.mask
        self.follow = self.pool_n = prog.follow
        self.batch = prog.batch * prog.n
        pools = [list(rank_pool(run, prog.shape, r, prog.pool_n, prog.dev))
                 for r in range(prog.n)]
        self.pool = [{"x": torch.cat([p[s % prog.pool_n] for p in pools])
                      .cpu()} for s in range(prog.follow)]
        self.noises = noises


def _drive(run, body):
    """Rank 0 with the workers around ``body(ranks, prog)``: the group
    formed, the workers stopped and joined after, or killed on a
    failure -> what ``body`` returns."""
    from octcubem_tpu_torch.core import multihost

    if run.device.type == "cuda":
        from octcubem_tpu_torch.ops import _cuda

        _cuda.build()   # once, before the workers look for the libraries
    ranks = Ranks(run)
    done = False
    try:
        _group(ranks.store, ranks.n, 0, run.device.type)
        prog = Program(run, 0, ranks.n)
        out = body(ranks, prog)
        ranks.post("stop")
        prog.free()
        multihost.shutdown()
        ranks.join()
        done = True
        return out, prog
    finally:
        ranks.release()
        if not done:
            ranks.kill()


def calibrate(run, controls=()) -> list:
    """Readings for the limits: rank 0 after the followed steps against the
    reference's one-rank steps on the global batch, and the readings
    named in ``controls`` (``control_fp8``, ``fault_half_batch``) as
    ``drivers/mae_train.py`` takes them."""
    def body(ranks, prog):
        return _follow(run, ranks, prog)

    ours, prog = _drive(run, body)
    single = _single_rank_driver()
    glob = GlobalBatch(run, prog, ours["noises"])
    ref = single.reference_readings(run, glob)
    out = [{"reading": "program", "rank_param_mismatch": ours["mismatch"],
            **training.gaps(ours, ref, run.device)}]
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"rows": range(glob.batch // 2)})):
        if name in controls:
            out.append({"reading": name, **training.gaps(
                single.reference_readings(run, glob, **kw), ref,
                run.device)})
    return out


def run(run) -> None:
    import octcubem_tpu_torch.nn.layers as layers

    def body(ranks, prog):
        ours = _follow(run, ranks, prog)
        start = prog.follow

        def feed(i):
            ranks.post(f"step:{start + i}")
            return prog.feed(start + i)

        ranks.post("reset")
        training.measure_window(run, feed, prog.call, prog.batch * prog.n)
        ranks.post("peak")
        run.peak_bytes = peak_bytes(prog)
        run.window["flops"] = (run.cfgmod.mae_flops_per_sample(prog.geom)
                               * run.window["samples"])
        if run.trace:
            def traced(i):
                ranks.post(f"step:{i}")
                return prog.feed(i)

            training.stretch(run, traced, prog.call, prog.tx, layers,
                             run.traffic["trace_steps"],
                             start=start + run.window["steps"])
        return ours

    ours, prog = _drive(run, body)
    run.check("failed_steps", run.failed, 0)
    run.check("rank_param_mismatch", ours["mismatch"], 0)
    t = time.perf_counter()
    single = _single_rank_driver()
    ref = single.reference_readings(run, GlobalBatch(run, prog,
                                                     ours["noises"]))
    run.note(f"reference: {time.perf_counter() - t:.1f} s for "
             f"{prog.follow} steps on the global batch of "
             f"{prog.batch * prog.n}")
    training.compare(run, ours, ref)


def worker(spec: dict) -> int:
    """A rank other than 0, from the JSON rank 0 started it with."""
    import torch.distributed as dist

    import run as bench
    from harness.core import Run

    if spec["cpus"]:
        os.sched_setaffinity(0, spec["cpus"])
    bench.set_environment()
    cell, config, cfgmod, _, _ = bench.load_cell(spec["workload"])
    rank, n = spec["rank"], spec["n"]
    dev = (torch.device("cuda", rank) if spec["device"] == "cuda"
           else torch.device("cpu"))
    torch.set_num_threads(4)
    r = Run(workload=cell, config=config, cfgmod=cfgmod, seed=spec["seed"],
            seconds=0, trace=False, device=dev, cache=bench.CACHE,
            t_start=time.time(), overrides=spec["overrides"])
    store = dist.TCPStore("127.0.0.1", spec["port"], n, is_master=False,
                          timeout=TIMEOUT)
    _group(store, n, rank, spec["device"])
    prog = Program(r, rank, n)
    serve(prog, dist.PrefixStore("bench", store))
    prog.free()
    dist.destroy_process_group()
    bad = bench.forbidden_modules()
    if bad:
        print(f"rank {rank} loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(worker(json.loads(sys.argv[2])))
    sys.exit(f"usage: {sys.argv[0]} --worker JSON (started by rank 0)")

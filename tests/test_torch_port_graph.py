"""The MAE step replayed as a captured CUDA graph (train/step_graph.py) on
the card, against the same step run eagerly from the same seeded state
by two twins that never capture (``MAX_GRAPHS`` 0 around their calls).
The twins' AdamW counts are on the card too, so all three run the same
update arithmetic (the device count's update against optax's:
tests/test_torch_port_train.py).

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no
JAX:

    python -m pytest --noconftest tests/test_torch_port_graph.py

Run to run: losses, grad norms and frame losses are held to the first
twin within chip_smoke.py's run-to-run tolerance (2^-7 of the twin's
largest entry), or where the two twins differ by more, within twice
their distance at that entry.  Every parameter entry is held to the
first twin within 2^-7 of the twin's largest entry of its leaf, except
the round-off entries: B2 sums dq in varying order, and an entry whose
gradient is round-off (the key third of a fused q/k/v bias, under the
softmax, or a gradient near a sign change) takes Adam steps of either
sign.  They are found from the twins alone, never from the replay: an
entry whose twins' gradients differed by more than a quarter of the
first twin's at some step, or whose twins' params differ by more than
the tolerance.  Nine in ten of the model's entries are checked.

The data-parallel step on two NCCL ranks (needs two cards; skips with
fewer): each rank is a spawned process that runs the same trio over a
data mesh of both, with its own rows, and writes what it saw; rank 0
runs one call under ``torch.profiler`` (so eagerly) while rank 1
replays it, as the benchmark's traced stretch does.
"""

import contextlib
import datetime
import faulthandler
import json
import traceback
from unittest import mock

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.train import mae_engine, optim, schedules, step_graph
from octcubem_tpu_torch.train.train_state import TrainState
from octcubem_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

TOL = 2 ** -7
NOISE = 0.25  # a gradient whose twins differ by this share: round-off
CHECKED = 0.9  # the least share of parameter entries held to TOL
DP_WORLD = 2
DP_STEPS = 6
DP_PROFILED = 3  # the call rank 0 runs under a profiler
DP_JOIN_S = 300


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _build(eager: bool, lr=None, joint=False, accum_2d=1, remat_2d=False,
           mesh=None, **kw):
    """A small bf16 MAE on the card (2 + 1 blocks, B1 and B2 throughout),
    its AdamW, state and step (over ``mesh``, the state replicated from
    rank 0); ``eager``: the step never captures."""
    from octcubem_tpu_torch.models import mae3d

    model = mae3d.create_model(
        mae3d.MaskedAutoencoderViT3D, device="cuda", seed=1, input_size=64,
        high_res_input_size=128, patch_size=16, in_chans=1, embed_dim=128,
        depth=2, num_heads=2, decoder_embed_dim=128, decoder_depth=1,
        decoder_num_heads=4, num_frames=24, t_patch_size=3, pred_t_dim=24,
        dtype=torch.bfloat16, **kw)
    if lr is None:
        lr = schedules.warmup_half_cosine(1e-3, 0.0, 1, 10, 2)
    tx = optim.build_adamw(model, lr, weight_decay=0.05 if lr else 0.0)
    state = mae_engine.replicate_state(
        TrainState.create(model, tx, seed=2), mesh)
    step = mae_engine.make_mae_train_step(
        model, tx, joint=joint, accum_2d=accum_2d,
        model2d=model.with_remat() if remat_2d else None, mesh=mesh)
    if eager:
        graphed = step

        def step(*args, **kwargs):
            with mock.patch.object(step_graph, "MAX_GRAPHS", 0):
                return graphed(*args, **kwargs)
    return step, state


def _close(got, ref, twin, what):
    """A metric, entry by entry (module docstring)."""
    got, ref, twin = got.float(), ref.float(), twin.float()
    tol = (2 * (twin - ref).abs()).clamp(min=TOL * ref.abs().max().item())
    err = (got - ref).abs()
    bad = err > tol
    assert not bad.any(), (f"{what}: {err[bad].max().item():.3e} > "
                           f"{tol[bad].min().item():.3e}")


class _Trio:
    """The replayed step and state (first), then two eager twins', and
    for each param the entries found to be round-off so far."""

    def __init__(self, **kw):
        built = [_build(eager, **kw) for eager in (False, True, True)]
        self.steps = [s for s, _ in built]
        self.states = [st for _, st in built]
        self.noisy = {}

    def run(self, *args, steps=None, **kw):
        """One call of each step (or of ``steps``, by index) on its state
        -> the metrics, in order."""
        out = []
        for i in range(3) if steps is None else steps:
            self.states[i], m = self.steps[i](self.states[i], *args, **kw)
            out.append(m)
        return out

    def agree(self, metrics):
        """The replayed state and metrics against the eager twins'."""
        (a, b, c), (ma, mb, mc) = self.states, metrics
        for k in ("loss", "loss_3d", "loss_2d", "grad_norm", "frame_losses"):
            _close(ma[k], mb[k], mc[k], k)
        pa = dict(a.params.named_parameters())
        pc = dict(c.params.named_parameters())
        checked = total = 0
        for n, pb in b.params.named_parameters():
            got, ref, twin = pa[n].float(), pb.float(), pc[n].float()
            gb, gc = (torch.zeros_like(ref) if q.grad is None
                      else q.grad.float() for q in (pb, pc[n]))
            tol = TOL * ref.abs().max().item()
            noisy = self.noisy.get(n, torch.zeros_like(ref, dtype=torch.bool))
            noisy |= (gb - gc).abs() > NOISE * gb.abs()
            self.noisy[n] = noisy
            keep = ~(noisy | ((twin - ref).abs() > tol))
            err = (got - ref).abs()[keep]
            assert not (err > tol).any(), (
                f"{n}: {err.max().item():.3e} > {tol:.3e} over "
                f"{keep.sum().item()} of {keep.numel()} entries")
            checked += keep.sum().item()
            total += keep.numel()
        assert checked >= CHECKED * total, (checked, total)


def _paths(since):
    return [r["path"] for r in profiling.records_since(since)]


def test_replayed_steps_match_eager(gen):
    """Four steps of one seeded state, replayed against eager: warm-up,
    capture and two replays, each call's metrics its own tensors."""
    x = [torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
         for _ in range(4)]
    noise = [torch.rand((2, 128), generator=gen, device="cuda")
             for _ in range(4)]
    trio = _Trio()
    seen = profiling.last_seq()
    outs = []
    for i in range(4):
        ms = trio.run(x[i], 0.9, noise=noise[i])
        trio.agree(ms)
        outs.append(ms[0])
    recs = profiling.records_since(seen)[::3]
    assert [r["path"] for r in recs] == ["warmup", "capture", "replay",
                                         "replay"]
    assert 0 < recs[1]["pool_bytes"] <= recs[1]["reserved_bytes"]
    assert set(recs[2]["phases"]) == {"replay"}
    assert outs[2]["loss"].data_ptr() != outs[3]["loss"].data_ptr()
    assert not torch.equal(outs[2]["loss"], outs[3]["loss"])
    a, b, _ = trio.states
    assert a.step == b.step == 4 and int(a.tx.count) == int(b.tx.count) == 4


def test_replays_draw_new_noise(gen):
    """With noise=None the graph draws from the state's generator on every
    replay: at LR 0 (the params never move) two replays on one batch give
    two losses, each the eager twins' of the same draw, and the generator
    advances as theirs does."""
    x = torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
    trio = _Trio(lr=0.0)
    losses = []
    for _ in range(4):
        ms = trio.run(x, 0.9)
        trio.agree(ms)
        losses.append(ms[0]["loss"].item())
    assert losses[1] != losses[2] != losses[3]
    a, b, _ = trio.states
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_profiled_step_runs_eagerly_between_replays(gen):
    """A step that a profiler records runs eagerly (its record profiled,
    its path eager) and the replays after it carry on from its state."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
    noise = [torch.rand((2, 128), generator=gen, device="cuda")
             for _ in range(6)]
    trio = _Trio()
    seen = profiling.last_seq()
    for i in range(6):
        if i == 3:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                ms = trio.run(x, 0.9, noise=noise[i], steps=[0])
            ms += trio.run(x, 0.9, noise=noise[i], steps=[1, 2])
        else:
            ms = trio.run(x, 0.9, noise=noise[i])
        trio.agree(ms)
    recs = profiling.records_since(seen)[::3]
    assert [r["path"] for r in recs] == ["warmup", "capture", "replay",
                                         "eager", "replay", "replay"]
    assert [r["profiled"] for r in recs] == [False] * 3 + [True] + [False] * 2
    grads = trio.steps[0].graphs.last.grads
    assert all(p.grad is g for p, g in
               zip(trio.states[0].params.parameters(), grads))


def test_replay_launches_what_the_eager_step_launches():
    """The ViT-L MAE step (train_entry: 24 + 8 blocks, batch 4): 32 B1,
    32 B2 and one AdamW launch counted in each call, warm-up, capture and
    replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from octcubem_tpu_torch.entry import train_entry

    step, state, x = train_entry()
    noise = torch.rand((4, 5120), device="cuda")
    seen = profiling.last_seq()
    for _ in range(3):
        _cuda.reset_launches()
        state, m = step(state, x, 0.9, noise=noise)
        torch.cuda.synchronize()
        assert {k: n for k, n in _cuda.launches.items() if n} == {
            "flash_fwd_packed": 32, "flash_bwd_packed": 32, "adamw": 1}
    assert _paths(seen) == ["warmup", "capture", "replay"]
    assert torch.isfinite(m["loss"]).item()


def test_joint_accum_2d_replays_and_matches_eager(gen):
    """The joint step with the 2D batch in 4 microbatches: captured and
    replayed, against eager."""
    x = torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
    x2 = torch.rand((4, 2, 3, 128, 128, 1), generator=gen, device="cuda")
    trio = _Trio(joint=True, accum_2d=4)
    seen = profiling.last_seq()
    for _ in range(4):
        ms = trio.run(x, 0.9, batch2d=x2, mask_ratio_2d=0.75)
        trio.agree(ms)
    assert _paths(seen)[::3] == ["warmup", "capture", "replay", "replay"]
    assert ms[0]["loss_2d"].item() > 0


@pytest.mark.parametrize("drop_path", [0.0, 0.1])
def test_remat_2d_replays_or_runs_eagerly(gen, drop_path):
    """The joint step through a remat model2d: without drop path its
    checkpointed blocks draw nothing and it replays; with drop path their
    recompute needs a new generator, which no capture allows, so the step
    runs eagerly from its first call.  Both against eager."""
    x = torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
    x2 = torch.rand((4, 3, 128, 128, 1), generator=gen, device="cuda")
    trio = _Trio(joint=True, remat_2d=True, drop_path_rate=drop_path)
    seen = profiling.last_seq()
    for _ in range(4):
        ms = trio.run(x, 0.9, batch2d=x2, mask_ratio_2d=0.75)
        trio.agree(ms)
    recs = profiling.records_since(seen)[::3]
    assert [r["path"] for r in recs] == (
        ["eager"] * 4 if drop_path
        else ["warmup", "capture", "replay", "replay"])
    if drop_path:
        assert not trio.steps[0].graphs.graphs  # not even a warm-up
    a, b, _ = trio.states
    assert a.step == b.step == 4
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@torch.no_grad()
def _rank_mismatch(params) -> int:
    """Entries on which the ranks' params differ in bits (a collective)."""
    bad = 0
    for p in params:
        hi, lo = p.detach().clone(), p.detach().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        bad += int((hi.view(torch.int32) != lo.view(torch.int32)).sum())
    return bad


def _dp_rank(rank, store_path, out_path):
    """One NCCL rank of ``test_data_parallel_replays_match_eager``: the
    trio over a data mesh of both ranks; writes what it saw, or the
    traceback, to ``out_path``."""
    from torch.profiler import ProfilerActivity, profile

    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.core.mesh import make_mesh

    # a hung rank prints its stack and exits before the join gives up
    faulthandler.dump_traceback_later(DP_JOIN_S - 60, exit=True)
    try:
        multihost.initialize(store=dist.FileStore(store_path, DP_WORLD),
                             world_size=DP_WORLD, rank=rank, device="cuda",
                             timeout_s=120)
        mesh = make_mesh(n_data=DP_WORLD)
        gen = torch.Generator(device="cuda").manual_seed(10 + rank)
        trio = _Trio(mesh=mesh)
        seen = profiling.last_seq()
        launches, mismatch = [], []
        for i in range(DP_STEPS):
            x = torch.rand((2, 24, 64, 64, 1), generator=gen, device="cuda")
            traced = rank == 0 and i == DP_PROFILED
            _cuda.reset_launches()
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()):
                ms = trio.run(x, 0.9, steps=[0])
            torch.cuda.synchronize()
            launches.append({k: n for k, n in _cuda.launches.items() if n})
            ms += trio.run(x, 0.9, steps=[1, 2])
            trio.agree(ms)
            mismatch.append(_rank_mismatch(trio.states[0].params.parameters()))
        recs = profiling.records_since(seen)[::3]
        out = {"paths": [r["path"] for r in recs],
               "profiled": [r["profiled"] for r in recs],
               "launches": launches, "mismatch": mismatch,
               "steps": [st.step for st in trio.states]}
        multihost.shutdown()  # with the graphs alive: it drops them first
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f)
    if "error" in out:
        raise SystemExit(1)


def test_data_parallel_replays_match_eager(tmp_path):
    """Two NCCL ranks, six steps of the data-parallel MAE step with the
    engine's global noise: each rank's replays against its eager twins,
    the gradient and loss all-reduces inside the graph; both ranks'
    params bit-equal after every step, also after the call rank 0 runs
    eagerly under a profiler while rank 1 replays; ``path`` ``replay``
    from the third call on (but that one); every call of the replayed
    step counts the launches of the warm-up."""
    if torch.cuda.device_count() < DP_WORLD:
        pytest.skip(f"needs {DP_WORLD} CUDA devices")
    ctx = mp.get_context("spawn")
    outs = [tmp_path / f"rank{r}.json" for r in range(DP_WORLD)]
    procs = [ctx.Process(target=_dp_rank,
                         args=(r, str(tmp_path / "store"), str(outs[r])))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=DP_JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {DP_JOIN_S} s"
    got = [json.loads(o.read_text()) if o.exists()
           else {"error": f"rank {r} wrote nothing (its stack: stderr)"}
           for r, o in enumerate(outs)]
    errors = [g["error"] for g in got if "error" in g]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * DP_WORLD
    replayed = ["warmup", "capture"] + ["replay"] * (DP_STEPS - 2)
    eager_at = replayed[:DP_PROFILED] + ["eager"] + replayed[DP_PROFILED + 1:]
    assert got[0]["paths"] == eager_at
    assert got[1]["paths"] == replayed
    assert got[0]["profiled"] == [i == DP_PROFILED for i in range(DP_STEPS)]
    for g in got:
        assert g["mismatch"] == [0] * DP_STEPS
        assert g["steps"] == [DP_STEPS] * 3
        assert g["launches"][0]["adamw"] == 1
        assert all(n == g["launches"][0] for n in g["launches"])

"""Port parity: the sequence-parallel attention layer on 4 gloo ranks
against the JAX package on a 4-device slice of the 8-device CPU mesh.

Four CPU processes (``torch.multiprocessing``, spawn) form a gloo group
through a ``FileStore`` under the test's tmp directory (no port); each
runs every case on its shard once per module and writes numpy results,
which the parametrised tests assemble and compare with the JAX functions
fed the same numpy inputs.  JAX is imported inside the tests only, so the
spawned ranks never import it.  The process group times out after 60 s
and the join is bounded, so a deadlock fails the tests instead of
hanging the run.

Tolerances: the JAX kernel tests' fp32 5e-5 on outputs and 5e-4 on
gradients; the transformer stack's 2e-4 / 1e-3
(tests/test_sequence_parallel.py).  The ranks run the kernels' plain
versions (CPU tensors); the JAX side runs its Pallas kernels in
interpret mode.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
JOIN_S = 240
TOL_O = dict(atol=5e-5, rtol=5e-5)
TOL_G = dict(atol=5e-4, rtol=5e-4)
STACK = dict(b=2, n=30, dim=64, heads=2)  # 30 tokens padded to 32 over 4


def _inputs():
    """Every case's numpy inputs, seeded."""
    rng = np.random.default_rng(0)

    def qkvg(b, h, n, d, g_rows=None):
        q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32)
                      for _ in range(4))
        if g_rows is not None:
            g[:, :, g_rows:] = 0.0  # the loss reads the valid rows only
        return dict(q=q, k=k, v=v, g=g)

    s = STACK
    x = rng.standard_normal((s["b"], s["n"], s["dim"])).astype(np.float32)
    gx = rng.standard_normal(x.shape).astype(np.float32)
    return {"sp": qkvg(1, 2, 4 * 32, 32), "pad": qkvg(1, 2, 104, 32, 100),
            "ring": qkvg(2, 2, 4 * 32, 16), "dpsp": qkvg(4, 2, 2 * 24, 16),
            "stack": dict(x=x, g=gx)}


# ------------------------------------------------------------- the ranks

def _run_attn(fn, data, bsl, ssl, **kw):
    """fn on this rank's shard (batch slice bsl, sequence slice ssl) with
    the shard of the cotangent -> {out, dq, dk, dv} as numpy."""
    ts = [torch.from_numpy(np.ascontiguousarray(data[n][bsl][:, :, ssl]))
          .requires_grad_() for n in "qkv"]
    out = fn(*ts, **kw)
    out.backward(torch.from_numpy(np.ascontiguousarray(data["g"][bsl][:, :, ssl])))
    res = {"out": out.detach().numpy()}
    res.update({f"d{n}": t.grad.numpy() for n, t in zip("qkv", ts)})
    return res


def _rank_main(rank, store_path, inputs, state_dict, out_dir):
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.nn.layers import TransformerStack
    from octcubem_tpu_torch.parallel.sequence import (
        ring_attention, sequence_parallel_attention, shard_sequence,
        use_sequence_parallel)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        res = {}

        def put(prefix, d):
            res.update({f"{prefix}/{k}": v for k, v in d.items()})

        mesh = make_mesh(n_data=1, n_sp=WORLD, device="cpu")
        full = slice(None)

        def seq(n):
            n_loc = n // WORLD
            return slice(rank * n_loc, (rank + 1) * n_loc)

        for no_max in (True, False):
            put(f"sp_{no_max}", _run_attn(
                sequence_parallel_attention, inputs["sp"], full, seq(128),
                mesh=mesh, no_max=no_max))
            put(f"pad_{no_max}", _run_attn(
                sequence_parallel_attention, inputs["pad"], full, seq(104),
                mesh=mesh, no_max=no_max, n_valid=100))

        saved = []

        def pack(t):
            saved.append(t.shape)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            put("ring", _run_attn(ring_attention, inputs["ring"], full,
                                  seq(128), mesh=mesh))
        res["ring_saved_seq"] = np.array([s[2] if len(s) > 2 else -1
                                          for s in saved])

        # composed (data, sp) 2 x 2: batch over data, sequence over sp
        mesh2 = make_mesh(n_data=2, n_sp=2, device="cpu")
        di, si = mesh2.get_local_rank("data"), mesh2.get_local_rank("sp")
        bsl, ssl = slice(2 * di, 2 * di + 2), slice(24 * si, 24 * si + 24)
        for name, fn in (("sp", sequence_parallel_attention),
                         ("ring", ring_attention)):
            put(f"dpsp_{name}", _run_attn(fn, inputs["dpsp"], bsl, ssl,
                                          mesh=mesh2, axis="sp",
                                          batch_axis="data"))

        # the transformer stack with attn_impl="flash_sp" on token shards
        s = STACK
        stack = TransformerStack(2, s["dim"], s["heads"], parity="standard",
                                 attn_impl="flash_sp")
        stack.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()}, strict=True)
        x = shard_sequence(torch.from_numpy(inputs["stack"]["x"]), mesh,
                           dim=1)
        g = shard_sequence(torch.from_numpy(inputs["stack"]["g"]), mesh,
                           dim=1)
        with use_sequence_parallel(mesh, "sp", n_valid=s["n"]):
            out = stack(x)
        out.backward(g)  # g is 0 on the pad rows
        res["stack/out"] = out.detach().numpy()
        res.update({f"stack/grad/{n}": p.grad.numpy()
                    for n, p in stack.named_parameters()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------- the test process

def _stack_params():
    """The JAX stack's params (naive attention, the reference) and the
    port's state dict of them."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.nn.layers import TransformerStack
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    s = STACK
    ref = TransformerStack(2, s["dim"], s["heads"], parity="standard",
                           attn_impl="naive")
    params = ref.init(jax.random.key(4), jnp.zeros((1, s["n"], s["dim"])))
    sd = state_dict_from_jax({"blocks": params["params"]})
    return ref, params, {k[len("blocks."):]: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every case on 4 gloo ranks -> (inputs, [per-rank results])."""
    tmp = tmp_path_factory.mktemp("gloo")
    inputs = _inputs()
    _, _, sd = _stack_params()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), inputs, sd, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _assemble(results, key, bslices=None):
    """Concatenate the ranks' shards of ``key`` along the sequence (dim
    2), or place them by (batch, sequence) slices."""
    if bslices is None:
        return np.concatenate([r[key] for r in results], axis=2)
    b = max(bs.stop for bs, _ in bslices)
    first = results[0][key]
    out = np.zeros((b, first.shape[1], 2 * first.shape[2], first.shape[3]),
                   first.dtype)
    for r, (bs, ss) in zip(results, bslices):
        out[bs, :, ss] = r[key]
    return out


def _jax_mesh(shape=(WORLD,), names=("sp",)):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), names)


def _jax_vjp(fn, data, spec_names):
    """(out, dq, dk, dv) of fn on the sharded inputs with cotangent g."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = fn.keywords["mesh"]
    sh = NamedSharding(mesh, P(*spec_names))
    q, k, v, g = (jax.device_put(data[n], sh) for n in "qkvg")

    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))

    return [np.asarray(a) for a in jax.jit(run)(q, k, v, g)]


def _check(got, ref, mask=None):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = TOL_O if name == "out" else TOL_G
        if mask is not None:
            a, b = a[:, :, mask], b[:, :, mask]
        np.testing.assert_allclose(a, b, **tol, err_msg=name)


@pytest.mark.parametrize("no_max", [True, False])
def test_sequence_parallel_matches_jax(ranks, no_max):
    """4-way sequence_parallel_attention, B5 (no_max=True) or B6 forward,
    against the JAX function on 4 devices: output and q, k, v gradients
    (dk / dv reduce-scattered back to the shards)."""
    import functools

    from octcubem_tpu.parallel.sequence import sequence_parallel_attention

    inputs, results = ranks
    key = f"sp_{no_max}"
    got = [_assemble(results, f"{key}/{n}") for n in ("out", "dq", "dk", "dv")]
    ref = _jax_vjp(functools.partial(sequence_parallel_attention,
                                     mesh=_jax_mesh(), no_max=no_max),
                   inputs["sp"], (None, None, "sp", None))
    _check(got, ref)


@pytest.mark.parametrize("no_max", [True, False])
def test_sequence_parallel_padded_n_valid(ranks, no_max):
    """100 valid rows padded to 104 over 4 ranks with n_valid=100: the
    valid region matches the JAX function, and the pad rows' gradients are
    exactly 0 (keys zeroed and masked; pad query rows get no cotangent)."""
    import functools

    from octcubem_tpu.parallel.sequence import sequence_parallel_attention

    inputs, results = ranks
    key = f"pad_{no_max}"
    got = [_assemble(results, f"{key}/{n}") for n in ("out", "dq", "dk", "dv")]
    ref = _jax_vjp(functools.partial(sequence_parallel_attention,
                                     mesh=_jax_mesh(), no_max=no_max,
                                     n_valid=100),
                   inputs["pad"], (None, None, "sp", None))
    _check(got, ref, mask=slice(0, 100))
    for name, a in zip(("dq", "dk", "dv"), got[1:]):
        np.testing.assert_array_equal(a[:, :, 100:], 0.0, err_msg=name)


def test_ring_attention_matches_jax(ranks):
    """4-way ring_attention (k / v rotating by point-to-point sends, the
    blocks merged through their lse) against the JAX ring on 4 devices."""
    import functools

    from octcubem_tpu.parallel.sequence import ring_attention

    inputs, results = ranks
    got = [_assemble(results, f"ring/{n}") for n in ("out", "dq", "dk", "dv")]
    ref = _jax_vjp(functools.partial(ring_attention, mesh=_jax_mesh()),
                   inputs["ring"], (None, None, "sp", None))
    _check(got, ref)


def test_ring_attention_saves_only_local_blocks(ranks):
    """The O(N/sp) training memory: every tensor the ring's autograd saves
    is a local block (sequence length n_loc = 32), never the gathered
    N = 128 (the counterpart of the JAX test that finds no per-step stacked
    residual in the gradient's jaxpr)."""
    _, results = ranks
    for r in results:
        seq = r["ring_saved_seq"]
        assert len(seq) == 5, seq  # q, k, v, out [.., 32, D] and lse
        assert set(seq.tolist()) == {32}, seq


@pytest.mark.parametrize("fn_name", ["sp", "ring"])
def test_composed_data_sp(ranks, fn_name):
    """A (data, sp) 2 x 2 mesh, the batch over data and the sequence over
    sp: sequence_parallel_attention and ring_attention against the JAX
    functions with batch_axis='data'."""
    import functools

    from octcubem_tpu.parallel import sequence as jseq

    inputs, results = ranks
    fn = {"sp": jseq.sequence_parallel_attention,
          "ring": jseq.ring_attention}[fn_name]
    # rank = 2 * data index + sp index
    slices = [(slice(2 * (r // 2), 2 * (r // 2) + 2),
               slice(24 * (r % 2), 24 * (r % 2) + 24)) for r in range(WORLD)]
    got = [_assemble(results, f"dpsp_{fn_name}/{n}", slices)
           for n in ("out", "dq", "dk", "dv")]
    ref = _jax_vjp(functools.partial(fn, mesh=_jax_mesh((2, 2), ("data", "sp")),
                                     axis="sp", batch_axis="data"),
                   inputs["dpsp"], ("data", None, "sp", None))
    _check(got, ref)


def test_transformer_stack_flash_sp_matches_jax(ranks):
    """A 2-block TransformerStack with attn_impl="flash_sp" on 4 ranks'
    token shards (30 tokens padded to 32, n_valid from the context)
    against the JAX stack with attn_impl="naive" and the same params:
    the valid rows' output, and every parameter's gradient summed over
    the ranks, as data-parallel training would sum them."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    inputs, results = ranks
    ref_stack, params, _ = _stack_params()
    x, g = (jnp.asarray(inputs["stack"][n]) for n in "xg")

    def run(p, x, g):
        out, vjp = jax.vjp(lambda p: ref_stack.apply(p, x), p)
        return out, vjp(g)[0]

    out_ref, grads_ref = jax.jit(run)(params, x, g)
    n = STACK["n"]
    out = np.concatenate([r["stack/out"] for r in results], axis=1)[:, :n]
    np.testing.assert_allclose(out, np.asarray(out_ref), atol=2e-4, rtol=2e-4)
    ref = {k[len("blocks."):]: v.numpy() for k, v in
           state_dict_from_jax({"blocks": grads_ref["params"]}).items()}
    for name, want in ref.items():
        got = sum(r[f"stack/grad/{name}"] for r in results)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3,
                                   err_msg=name)


def test_flash_sp_requires_context():
    from octcubem_tpu_torch.ops.attention import (multi_head_attention_packed,
                                                  multi_head_attention_qkv)

    q = torch.ones((1, 16, 64))
    with pytest.raises(RuntimeError, match="use_sequence_parallel"):
        multi_head_attention_packed(q, q, q, 2, impl="flash_sp")
    with pytest.raises(RuntimeError, match="use_sequence_parallel"):
        multi_head_attention_qkv(torch.ones((1, 16, 192)), 2, impl="flash_sp")

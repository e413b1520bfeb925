"""Port parity: head-parallel attention (attn_impl="flash_tp") on 4 gloo
ranks against the JAX package, and the tp / fsdp placement policies leaf
by leaf.

Four CPU processes (``torch.multiprocessing``, spawn) form a gloo group
through ``core/multihost.initialize`` with a ``FileStore`` under the
test's tmp directory; each runs every case on its head group once per
module and writes numpy results, which the tests assemble and compare
with the JAX functions fed the same numpy inputs on a 4-device slice of
the conftest's 8-device CPU mesh.  JAX is imported inside the tests only,
so the spawned ranks never import it.  The group times out after 60 s
and the join is bounded.

Tolerances (tests/test_tensor_parallel.py): head_parallel_attention 5e-5
on outputs, 5e-4 on gradients; the flash_tp stack 2e-4 on outputs, 1e-3
on every gathered parameter gradient.  The ranks run the kernels' plain
versions (fixed-shift softmax), the JAX local body the exact one
(impl="auto" is naive on the CPU): the draws keep every logit below the
shift's clamp, where the two agree.
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
HEADS, D = 8, 32                  # 2 heads of 32 per rank: the packed path
STACK = dict(b=2, n=129, dim=256, heads=8, depth=2)  # cls-prefixed n
TOL_O = dict(atol=5e-5, rtol=5e-5)
TOL_G = dict(atol=5e-4, rtol=5e-4)
TOL_STACK_O = dict(atol=2e-4, rtol=2e-4)
TOL_STACK_G = dict(atol=1e-3, rtol=1e-3)


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for n in (64, 129):  # 129: the cls fold
        out[f"attn{n}"] = {k: rng.standard_normal((2, n, HEADS * D)).astype(
            np.float32) for k in "qkv"}
    s = STACK
    out["stack"] = {"x": rng.standard_normal((s["b"], s["n"], s["dim"]))
                    .astype(np.float32)}
    return out


# ------------------------------------------------------------- the ranks

def _rank_main(rank, store_path, inputs, sd, out_dir):
    from torch.distributed.device_mesh import DeviceMesh

    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.nn.layers import TransformerStack
    from octcubem_tpu_torch.parallel.tensor import (
        gather_tp_state_dict, head_parallel_attention, shard_tp_params,
        use_tensor_parallel)

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, WORLD),
                         world_size=WORLD, rank=rank, device="cpu",
                         timeout_s=60)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("tp",))
        res = {}
        loc = HEADS * D // WORLD
        cols = slice(rank * loc, (rank + 1) * loc)
        for n in (64, 129):
            ts = [torch.from_numpy(np.ascontiguousarray(
                inputs[f"attn{n}"][k][..., cols])).requires_grad_()
                for k in "qkv"]
            out = head_parallel_attention(*ts, HEADS, mesh)
            (out.float() ** 2).sum().backward()
            res[f"attn{n}/out"] = out.detach().numpy()
            res.update({f"attn{n}/d{k}": t.grad.numpy()
                        for k, t in zip("qkv", ts)})

        s = STACK
        stack = TransformerStack(s["depth"], s["dim"], s["heads"],
                                 parity="standard", attn_impl="flash_tp")
        stack.load_state_dict({k: torch.from_numpy(v)
                               for k, v in sd.items()}, strict=True)
        shard_tp_params(stack, mesh)
        res["wqkv_local_rows"] = np.array(
            stack[0].mixer.Wqkv.weight.shape[0])
        with use_tensor_parallel(mesh, "tp"):
            out = stack(torch.from_numpy(inputs["stack"]["x"]))
        (out.float() ** 2).sum().backward()
        res["stack/out"] = out.detach().numpy()
        full = gather_tp_state_dict(stack, mesh)
        grads = gather_tp_state_dict(stack, mesh, grads=True)
        res.update({f"stack/param/{k}": v.numpy() for k, v in full.items()})
        res.update({f"stack/grad/{k}": v.numpy() for k, v in grads.items()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        multihost.shutdown()


# ----------------------------------------------------- the test process

def _stack_params():
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.nn.layers import TransformerStack
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    s = STACK
    params = TransformerStack(s["depth"], s["dim"], s["heads"],
                              parity="standard", attn_impl="naive").init(
        jax.random.key(4), jnp.zeros((1, s["n"], s["dim"])))
    # perturb the init so zero biases and unit LN scales carry signal
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)
    sd = state_dict_from_jax({"blocks": params["params"]})
    return params, {k[len("blocks."):]: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 4 gloo ranks -> (inputs, JAX params, [results])."""
    tmp = tmp_path_factory.mktemp("gloo_tp")
    inputs = _inputs()
    params, sd = _stack_params()
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
    return inputs, params, [dict(np.load(tmp / f"rank{r}.npz"))
                            for r in range(WORLD)]


def _tp_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))


@pytest.mark.parametrize("n", [64, 129])
def test_head_parallel_attention_matches_jax(ranks, n):
    """The ranks' output shards and q, k, v gradient shards, concatenated
    along the packed minor dim, against JAX's head_parallel_attention on
    a 4-device tp mesh (one pair of heads a device)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from octcubem_tpu.parallel.tensor import head_parallel_attention

    inputs, _, results = ranks
    mesh = _tp_mesh()
    spec = NamedSharding(mesh, P(None, None, "tp"))
    q, k, v = (jax.device_put(jnp.asarray(inputs[f"attn{n}"][c]), spec)
               for c in "qkv")

    def loss(q, k, v):
        return (head_parallel_attention(q, k, v, HEADS, mesh)
                .astype(jnp.float32) ** 2).sum()

    out = head_parallel_attention(q, k, v, HEADS, mesh)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    got = np.concatenate([r[f"attn{n}/out"] for r in results], axis=-1)
    np.testing.assert_allclose(got, np.asarray(out), **TOL_O)
    for c, g in zip("qkv", grads):
        got = np.concatenate([r[f"attn{n}/d{c}"] for r in results], axis=-1)
        np.testing.assert_allclose(got, np.asarray(g), **TOL_G, err_msg=c)


def test_flash_tp_stack_matches_jax(ranks):
    """A 2-block stack of 8 heads under flash_tp with shard_tp_params'
    shards: each rank holds 2 heads' rows of each of q, k and v (192 of
    Wqkv's 768 rows); its output against JAX's
    flash_tp stack on the 4-device mesh (tp-sharded params) and against
    the unsharded naive stack; every gathered parameter gradient against
    the unsharded stack's (tests/test_tensor_parallel.py proves the two
    JAX stacks equal)."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.nn.layers import TransformerStack
    from octcubem_tpu.parallel.tensor import (shard_tp_params,
                                              use_tensor_parallel)
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    inputs, params, results = ranks
    s = STACK
    x = jnp.asarray(inputs["stack"]["x"])
    ref_stack = TransformerStack(s["depth"], s["dim"], s["heads"],
                                 parity="standard", attn_impl="naive")
    tp_stack = TransformerStack(s["depth"], s["dim"], s["heads"],
                                parity="standard", attn_impl="flash_tp")
    mesh = _tp_mesh()
    with use_tensor_parallel(mesh, "tp"):
        out_tp = jax.jit(tp_stack.apply)(shard_tp_params(params, mesh), x)

    def loss(p):
        return (ref_stack.apply(p, x).astype(jnp.float32) ** 2).sum()

    out_ref = ref_stack.apply(params, x)
    grads = state_dict_from_jax({"blocks": jax.grad(loss)(params)["params"]})
    sd = state_dict_from_jax({"blocks": params["params"]})
    for r in results:
        assert int(r["wqkv_local_rows"]) == 3 * s["dim"] // WORLD
        np.testing.assert_allclose(r["stack/out"], np.asarray(out_tp),
                                   **TOL_STACK_O)
        np.testing.assert_allclose(r["stack/out"], np.asarray(out_ref),
                                   **TOL_STACK_O)
        for key, g in grads.items():
            name = key[len("blocks."):]
            # the gather gives back the full state dict exactly
            np.testing.assert_array_equal(r[f"stack/param/{name}"],
                                          sd[key].numpy(), err_msg=name)
            np.testing.assert_allclose(r[f"stack/grad/{name}"], g.numpy(),
                                       **TOL_STACK_G, err_msg=name)


# ------------------------------------------- placement policies, no ranks

def _jax_tree(which):
    import jax
    import jax.numpy as jnp

    if which == "vit":
        from octcubem_tpu.models import vit_st

        model = vit_st.flash_attn_vit_large_patch16(
            num_frames=48, t_patch_size=3, img_size=256, in_chans=1,
            num_classes=16, head_type="dropout", global_pool=True)
        x = jax.ShapeDtypeStruct((1, 48, 256, 256, 1), jnp.float32)
        return jax.eval_shape(model.init, jax.random.key(0), x)["params"]
    from octcubem_tpu.models import mae3d

    model = mae3d.mae_vit_large_patch16()
    x = jax.ShapeDtypeStruct((1, model.num_frames, model.input_size,
                              model.input_size, 1), jnp.float32)
    return jax.eval_shape(
        lambda k, x: model.init({"params": k, "masking": k}, x,
                                mask_ratio=0.9), jax.random.key(0), x)["params"]


def _port_params(which):
    from octcubem_tpu_torch.models import mae3d, vit_st

    with torch.device("meta"):
        if which == "vit":
            model = vit_st.flash_attn_vit_large_patch16(
                num_frames=48, t_patch_size=3, img_size=256, in_chans=1,
                num_classes=16, head_type="dropout", global_pool=True)
        else:
            model = mae3d.mae_vit_large_patch16()
    return dict(model.named_parameters())


def _port_layout(spec, kind, ndim):
    """A JAX spec on a flax leaf -> the same placement on the port's
    layout of that leaf (compat/jax_params.state_dict_from_jax)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if not any(s is not None for s in spec):
        return ()
    if kind == "linear_w":
        return spec[::-1]
    if kind == "conv_patch":
        return tuple(spec[i] for i in (4, 3, 0, 1, 2))
    return spec


@pytest.mark.parametrize("which", ["vit", "mae"])
def test_placement_policies_match_jax_leaf_by_leaf(which):
    """tp_param_spec and fsdp_param_spec on every param of a ViT-L
    classifier and a mae3d ViT-L: JAX's spec on each flax leaf, carried
    to the port's layout of it, equals the port's spec on its tensor
    (shapes only: jax.eval_shape and meta tensors)."""
    import jax

    from octcubem_tpu.core.mesh import fsdp_param_spec as j_fsdp
    from octcubem_tpu.parallel.tensor import tp_param_spec as j_tp
    from octcubem_tpu_torch.compat.jax_params import _to_torch_key
    from octcubem_tpu_torch.core.mesh import fsdp_param_spec
    from octcubem_tpu_torch.parallel.tensor import tp_param_spec

    tree = _jax_tree(which)
    port = _port_params(which)
    seen, sharded = set(), {"tp": 0, "fsdp": 0}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, kind = _to_torch_key(tuple(k.key for k in path))
        assert name in port, name
        seen.add(name)
        t = port[name]
        for axis, j_fn, t_fn in (("tp", j_tp, tp_param_spec),
                                 ("fsdp", j_fsdp, fsdp_param_spec)):
            want = _port_layout(j_fn(path, leaf), kind, leaf.ndim)
            got = tuple(t_fn(name, t))
            assert got == want, (axis, name, got, want)
            sharded[axis] += bool(want)
    assert seen == set(port)
    assert sharded["tp"] == 4 * (24 if which == "vit" else 32)
    assert sharded["fsdp"] > 0

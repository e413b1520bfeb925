"""Checkpoints of the port (core/checkpoint.py, torch.save) against the JAX
package's orbax checkpoints, and the export CLI and registries.

- The same sequence of saves (keep_last, async, a repeated and an older
  step, the NaN cleanup) leaves the same step lists in both packages, and
  their readers return the same steps and metadata.
- A TrainState of the port (MAE, AdamW with fp32 or bf16 mu, generator)
  restores bit for bit into a fresh state, and the step after the resume
  equals the step the live state takes (on the CPU: bit for bit).
- An async save stages host copies before it returns: an in-place update
  of the live tensors right after it does not reach the file.
- ``cli/export.py`` turns a port run into a stamped .pth that the JAX
  package loads with equal params and whose stamp it checks.
- ``ckpt_registry`` and ``pretrained`` return what the JAX copies return.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.compat import pretrained as jpre
from octcubem_tpu.compat import torch_import as jimport
from octcubem_tpu.core import checkpoint as jckpt
from octcubem_tpu.core import ckpt_registry as jreg
from octcubem_tpu_torch.cli import export as texport_cli
from octcubem_tpu_torch.compat import pretrained as tpre
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.core import checkpoint as tckpt
from octcubem_tpu_torch.core import ckpt_registry as treg
from octcubem_tpu_torch.train import mae_engine as teng
from octcubem_tpu_torch.train import optim as topt
from octcubem_tpu_torch.train.train_state import TrainState

from test_torch_port_mae import jax_init, model_kw, torch_model, volume


def _listing(d):
    return sorted((n for n in os.listdir(d) if not n.startswith(".")),
                  key=lambda n: (not n.isdigit(), n))


def _run_sequence(ck, d, state):
    """One sequence of saves and deletes -> what each reader returned."""
    seen = []
    for step in range(5):
        ck.save_checkpoint(d, step, state, {"epoch": step}, keep_last=2)
    seen.append([int(n) for n in _listing(d)])
    ck.save_checkpoint(d, 4, state, {"epoch": 40}, keep_last=2)  # skipped
    ck.save_checkpoint(d, 1, state, {"epoch": 1}, keep_last=2)   # skipped
    ck.save_checkpoint(d, 7, state, None)
    seen.append([int(n) for n in _listing(d)])
    for step in (10, 11, 12):
        ck.save_checkpoint(d, step, state, {"epoch": step}, keep_last=2,
                           async_save=True)
    seen.append(ck.latest_step(d))
    seen.append([int(n) for n in _listing(d)])
    seen.append(ck.delete_recent_checkpoints(d, 1))
    seen.append(ck.latest_step(d))
    _, extra, step = ck.restore_checkpoint(d, state)
    seen.append((extra, step))
    _, step = ck.restore_raw(d, 11)
    seen.append(step)
    seen.append(ck.delete_recent_checkpoints(d, 5))
    seen.append(ck.latest_step(d))
    ck.wait_for_saves(d)
    ck.wait_for_saves()
    return seen


def test_step_lists_match_orbax(tmp_path):
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    ref = _run_sequence(jckpt, str(tmp_path / "jax"),
                        {"w": jnp.asarray(w), "step": jnp.asarray(3)})
    got = _run_sequence(tckpt, str(tmp_path / "port"),
                        {"w": torch.from_numpy(w), "step": 3})
    assert got == ref
    assert ref[0] == [3, 4] and ref[3] == [11, 12] and ref[4] == [12]
    with pytest.raises(FileNotFoundError):
        tckpt.restore_raw(str(tmp_path / "port"))


def test_raw_dict_round_trip(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 3,
             "nested": {"b": torch.ones(2, dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, 5, state, {"epoch": 5})
    raw, extra, step = tckpt.restore_checkpoint(d, {})
    assert step == 5 and extra == {"epoch": 5} and raw["step"] == 3
    assert torch.equal(raw["w"], state["w"])
    assert raw["nested"]["b"].dtype == torch.bfloat16
    assert sorted(os.listdir(d)) == ["5"]  # no temporary left behind


def _state(mu_dtype=None, seed=0, params_seed=0):
    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9, seed=params_seed)
    tm = torch_model(kw, params)
    tx = topt.build_fused_adamw(tm, 1e-3, weight_decay=0.05,
                                mu_dtype=mu_dtype)
    return TrainState.create(tm, tx, seed=seed)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.params.state_dict().items()},
            [m.clone() for m in state.tx.mu], [n.clone() for n in state.tx.nu],
            state.tx.count, state.step, state.generator.get_state())


def _assert_states_equal(a, b):
    pa, mua, nua, ca, sa, ga = _snapshot(a)
    pb, mub, nub, cb, sb, gb = _snapshot(b)
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(mua + nua, mub + nub))
    assert (ca, sa) == (cb, sb) and torch.equal(ga, gb)


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16])
def test_train_state_resumes_bit_exact(tmp_path, mu_dtype):
    """Two steps, an async save (keep_last=2), a restore into a state built
    from other params and seeds; then one more step from each."""
    x = torch.from_numpy(volume("a", seed=41))
    live = _state(mu_dtype)
    step = teng.make_mae_train_step(live.params, live.tx)
    for _ in range(2):
        live, _ = step(live, x, 0.9)
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, live.step, live, {"epoch": 1}, keep_last=2,
                          async_save=True)
    fresh = _state(mu_dtype, seed=9, params_seed=3)
    restored, extra, at = tckpt.restore_checkpoint(d, fresh)
    assert restored is fresh and at == 2 and extra == {"epoch": 1}
    _assert_states_equal(restored, live)
    m_live = step(live, x, 0.9)[1]
    m_res = teng.make_mae_train_step(fresh.params, fresh.tx)(fresh, x, 0.9)[1]
    for k in m_live:
        assert torch.equal(m_live[k], m_res[k]), k
    _assert_states_equal(fresh, live)


def test_async_save_stages_host_copies(tmp_path):
    """In-place updates right after an async save do not reach the file."""
    state = _state()
    before = _snapshot(state)
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 1, state, async_save=True)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
        torch._foreach_add_(state.tx.nu, 1.0)
    state.generator.manual_seed(123)
    raw, _ = tckpt.restore_raw(d)
    assert all(torch.equal(raw["params"][k], before[0][k]) for k in before[0])
    assert all(torch.equal(raw["opt_state"]["nu"][n], v)
               for n, v in zip(state.tx.names, before[2]))
    assert torch.equal(raw["generator"], before[5])


def test_optimizer_state_dict_checks_names_and_shapes():
    state = _state()
    sd = state.tx.state_dict()
    bad = dict(sd, mu={k: v for k, v in sd["mu"].items()
                       if k != "mask_token"})
    with pytest.raises(ValueError, match="names"):
        state.tx.load_state_dict(bad)
    bad = dict(sd, nu=dict(sd["nu"], mask_token=torch.zeros(3)))
    with pytest.raises(ValueError, match="mask_token"):
        state.tx.load_state_dict(bad)


def test_export_cli_writes_a_stamped_pth_jax_loads(tmp_path, capsys):
    state = _state()
    run = tmp_path / "run"
    tckpt.save_checkpoint(str(run / "ckpt"), 3, state)
    tckpt.save_checkpoint(str(run / "ckpt"), 5, state)
    with open(run / "args.json", "w") as f:
        json.dump({"model": "mae_vit_large_patch16", "num_heads": 8,
                   "decoder_num_heads": 4, "lr": 1.0}, f)
    out = str(tmp_path / "enc.pth")
    assert texport_cli.main(["--ckpt", str(run), "--out", out]) == out
    printed = capsys.readouterr().out
    assert "WARNING" in printed and "exported step 5" in printed
    payload = torch.load(out, weights_only=True)
    assert payload["epoch"] == 5
    assert payload["octcubem_tpu_geometry"] == {
        "model": "mae_vit_large_patch16", "num_heads": 8,
        "decoder_num_heads": 4}
    with pytest.raises(SystemExit, match="num_heads=8"):
        jimport.check_geometry_stamp(out, 16)
    jimport.check_geometry_stamp(out, 8, decoder_num_heads=4)
    kw = model_kw("a")
    _, jtemplate = jax_init(kw, volume("a"), 0.9, seed=4)
    jparams, report = jimport.import_state_dict(
        jtemplate, jimport.load_torch_checkpoint(out))
    assert report == {"missing": [], "unexpected": []}
    ref = state_dict_from_jax(jparams)
    for k, v in state.params.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)

    # --step, the ckpt/ dir itself, retfound style, a subtree
    out2 = str(tmp_path / "blocks.pth")
    texport_cli.main(["--ckpt", str(run / "ckpt"), "--out", out2,
                      "--step", "3", "--style", "retfound",
                      "--subtree", "params/blocks"])
    sd = torch.load(out2, weights_only=True)["model"]
    assert "0.attn.qkv.weight" in sd and "0.mixer.Wqkv.weight" not in sd
    with pytest.raises(SystemExit, match="not found"):
        texport_cli.main(["--ckpt", str(run), "--out", out2,
                          "--subtree", "visual"])


def test_ckpt_registry_matches_jax(tmp_path):
    entries = {2: {"best_val": "b/2.pth", "best_test": "t/2.pth"},
               0: {"best_val": "b/0.pth", "best_test": "t/0.pth"}}
    for pkg, name in ((jreg, "jax.json"), (treg, "port.json")):
        pkg.save_ckpt_registry(str(tmp_path / name), entries)
    assert ((tmp_path / "jax.json").read_text()
            == (tmp_path / "port.json").read_text())
    for crit in ("best_val", "best_test"):
        assert (treg.cv_fold_ckpt_paths(str(tmp_path / "port.json"), crit)
                == jreg.cv_fold_ckpt_paths(str(tmp_path / "jax.json"), crit))
    assert (treg.load_ckpt_registry(str(tmp_path / "port.json"))
            == jreg.load_ckpt_registry(str(tmp_path / "jax.json")))
    assert (treg.scan_ckpt_registries(str(tmp_path))
            == jreg.scan_ckpt_registries(str(tmp_path)))
    assert treg.scan_ckpt_registries(str(tmp_path / "none")) == {}


def test_pretrained_registry_matches_jax(tmp_path, monkeypatch):
    assert tpre.describe() == jpre.describe()
    assert ({k: vars(v) for k, v in tpre.REGISTRY.items()}
            == {k: vars(v) for k, v in jpre.REGISTRY.items()})
    monkeypatch.delenv("OCTCUBEM_CKPT_DIR", raising=False)
    (tmp_path / "OCTCube.pth").write_bytes(b"")
    for name in tpre.REGISTRY:
        assert (tpre.locate(name, str(tmp_path))
                == jpre.locate(name, str(tmp_path)))
    assert tpre.locate("octcube", str(tmp_path)) == str(tmp_path / "OCTCube.pth")
    monkeypatch.setenv("OCTCUBEM_CKPT_DIR", str(tmp_path))
    assert tpre.locate("octcube", "/nonexistent") == jpre.locate(
        "octcube", "/nonexistent")

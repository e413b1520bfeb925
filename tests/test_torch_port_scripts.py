"""The card scripts' pieces that run without a card (CPU): the forward
bound of ``scripts/time_kernels.py``, the variant edits of
``scripts/ablate_fwd.py`` against the forward body as it is, the
kernel groups of ``scripts/profile_step.py``, and
``scripts/ft_naive_spread.py``'s refusal without a card."""

import pytest

from octcubem_tpu_torch.scripts import ablate_fwd, profile_step
from octcubem_tpu_torch.scripts import time_kernels as tk

# an H100 SXM: 16 exps per clock per SM, 132 SMs, 1,980 MHz max SM clock
H100_EXP_RATE = 16 * 132 * 1980e6


@pytest.mark.parametrize("d,by", [(32, "exp"), (64, "operations"),
                                  (80, "operations"), (128, "operations")])
def test_forward_bound_takes_the_exp_where_it_binds(d, by):
    """4 D FLOP per score against one exp: at 989 TFLOP/s and 4.2e12 exp/s
    the exp binds below D = 59, the products above (the decoder's
    (4, 5,121, 16, D) forward; its bytes bind at neither)."""
    work = tk.fwd_work(4, 16, 5120, 5121, d)
    flops, nbytes, exps = work
    assert exps == 4 * 16 * 5120 * 5121 and flops == 4 * d * exps
    ms, got = tk.bound(*work, H100_EXP_RATE)
    assert got == by
    assert ms == pytest.approx(1e3 * max(flops / tk.PEAK_BF16_FLOPS,
                                         nbytes / tk.PEAK_BYTES,
                                         exps / H100_EXP_RATE))


def test_backward_bound_leaves_the_exp_out():
    """A call given no exps is bound by its products or its bytes."""
    ms, by = tk.bound(1e12, 1e9)
    assert by == "operations" and ms == pytest.approx(1e15 / 989e12)
    assert tk.bound(1e6, 1e9)[1] == "bytes"


@pytest.mark.parametrize("name", sorted(ablate_fwd.VARIANTS))
def test_each_ablation_edit_applies_once(name):
    """Every variant's texts occur exactly once in flash_fwd.cuh as it is,
    and the edited body differs from it unless the variant is the base."""
    text = (ablate_fwd.ROOT / ablate_fwd.HEADER).read_text()
    out = ablate_fwd.edited(name, text)
    assert (out == text) == (name == "base")


def test_an_edit_that_does_not_apply_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        ablate_fwd.edited("noexp", "no such body")


_HOPPER = ("void (anonymous namespace)::fwd_hopper_kernel<{}, (anonymous "
           "namespace)::Softmax<0, 7>, 128, 2>(CUtensorMap_st, CUtensorMap_st, "
           "CUtensorMap_st, (anonymous namespace)::FwdParams)")


@pytest.mark.parametrize("name,group", [
    (_HOPPER.format(32), "flash forward, other head_dim (B1)"),
    (_HOPPER.format(80), "flash forward, head_dim 80 (B3 / B5)"),
    ("void (anonymous namespace)::fwd_bf16_kernel<256, false>("
     "(anonymous namespace)::FwdParams)", "flash forward, other head_dim (B1)"),
    ("void (anonymous namespace)::bwd_hopper_kernel<80>(CUtensorMap_st)",
     "flash backward, head_dim 80 (B4 / B7)"),
])
def test_step_profile_groups_each_flash_body(name, group):
    """Both forward bodies (the Hopper one and the mma.sync one) and the
    backward land in the flash groups, not among "other elementwise"."""
    assert profile_step.group_of(name) == group


def test_ft_naive_spread_needs_a_card(monkeypatch, capsys):
    """The limit-spread script measures on the card only: without a CUDA
    device it exits 2 and prints no reading."""
    import torch

    from octcubem_tpu_torch.scripts import ft_naive_spread

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ft_naive_spread.main(["--seeds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err

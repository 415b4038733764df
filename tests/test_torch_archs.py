"""The architecture index and the per-architecture smoke matrix of the
port (the twin of tests/test_archs.py), on the CPU.

Every architecture of the reference's ``configs.ARCHITECTURES`` resolves
in the port's ``get_config`` (by module name and by its dashed id) and
is built ``.reduced()`` (≤ 2 layers, 4 for the hybrid's groups, d_model
≤ 128, ≤ 4 experts) from the port's own seeded init:

* the training loss on a batch made from ``input_specs`` is finite;
* one SGD step (lr 0.01, momentum 0.9) leaves every leaf finite and
  moves a parameter of every family;
* the loss falls over 8 steps (lr 0.05);
* prefill and two greedy decode steps give finite (B, 1, V) logits, and
  prefill(t₀..tₙ)'s last logits equal decode of tₙ after
  prefill(t₀..tₙ₋₁) at 2e-2 (the reference test's grade); the audio
  encoder raises the reference's ``ValueError`` instead;
* the skip matrix of ``shape_applicable`` equals the live reference's,
  and ``param_count`` / ``active_param_count`` at full size (meta
  tensors) equal the reference's.

The port's side only: the families' parity with the reference's values
is held in tests/test_torch_{dense,moe,ssm_family,vlm_audio}.py.
"""
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models.api import active_param_count as jax_active_param_count
from repro.models.api import param_count as jax_param_count
from repro_torch import configs
from repro_torch.configs import ARCHITECTURES, get_config, shape_applicable
from repro_torch.kernels import ops
from repro_torch.models import active_param_count, build_model, \
    input_specs, param_count
from repro_torch.optim.sgd import sgd_step
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_zeros_like
from torch_threads import _one_torch_thread  # noqa: F401

BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


def _concrete_batch(cfg, mode, batch=BATCH, seq=SEQ):
    """``input_specs``' batch filled from numpy (seed 0): integers below
    the vocabulary, embeddings normal × 0.3 in their dtype."""
    specs = input_specs(cfg, mode=mode, batch=batch, seq=seq)
    rng = np.random.default_rng(0)

    def make(s):
        if not s.dtype.is_floating_point:
            hi = max(cfg.vocab_size - 1, 2)
            return torch.from_numpy(rng.integers(0, hi, tuple(s.shape)))
        return torch.from_numpy(rng.normal(size=tuple(s.shape)) * 0.3).to(
            s.dtype)

    return {k: make(v) for k, v in specs.items()}


@pytest.fixture(scope="module", params=ARCHITECTURES)
def arch_setup(request):
    cfg = get_config(request.param).reduced()
    model = build_model(cfg)
    return request.param, cfg, model, model.init(0, device="cpu")


def _value_and_grad(model, params, batch):
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


# ----------------------------------------------------------------------
# the index
# ----------------------------------------------------------------------


def test_index_is_the_references():
    assert ARCHITECTURES == jax_configs.ARCHITECTURES
    assert configs.INPUT_SHAPES == jax_configs.INPUT_SHAPES
    assert configs._ALIASES == jax_configs._ALIASES
    assert list(configs.all_configs()) == list(ARCHITECTURES)
    for alias, name in configs._ALIASES.items():
        assert get_config(alias) is get_config(name)


@pytest.mark.parametrize("name", ["no-such-model", "llama-7b", "granite"])
def test_unknown_architectures_raise_key_error(name):
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config(name)
    with pytest.raises(KeyError):
        jax_configs.get_config(name)


@pytest.mark.parametrize("name", ["paper_mnist", "paper-cifar"])
def test_paper_workloads_are_not_model_configs(name):
    """The reference reaches the module's ``CONFIG``, which it lacks (an
    AttributeError); the port points to its ``workload()``."""
    with pytest.raises(KeyError, match="workload"):
        get_config(name)
    with pytest.raises(AttributeError):
        jax_configs.get_config(name)


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_config_and_counts_are_the_references(arch):
    import dataclasses

    got, want = get_config(arch), jax_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(
        want.reduced())
    assert param_count(got) == jax_param_count(want)
    assert active_param_count(got) == jax_active_param_count(want)
    assert (active_param_count(got) < param_count(got)) == \
        (got.family == "moe")


def test_skip_matrix_is_the_references():
    for arch in ARCHITECTURES:
        for shape in configs.INPUT_SHAPES:
            assert shape_applicable(get_config(arch), shape) == \
                jax_configs.shape_applicable(jax_configs.get_config(arch),
                                             shape), (arch, shape)
    # The reference test's design: hubert has no decode, the
    # sub-quadratic architectures run long_500k, every one trains.
    assert not shape_applicable(get_config("hubert_xlarge"),
                                "decode_32k")[0]
    for a in ("mamba2_2_7b", "zamba2_2_7b", "mixtral_8x7b"):
        assert shape_applicable(get_config(a), "long_500k")[0], a
    for a in ARCHITECTURES:
        assert shape_applicable(get_config(a), "train_4k")[0], a


# ----------------------------------------------------------------------
# the smoke matrix
# ----------------------------------------------------------------------


class TestSmokeTrainStep:
    def test_loss_finite(self, arch_setup):
        arch, cfg, model, params = arch_setup
        loss = model.loss(params, _concrete_batch(cfg, "train"))
        assert loss.shape == ()
        assert bool(torch.isfinite(loss)), f"{arch}: loss={loss}"

    def test_one_train_step_updates_and_no_nans(self, arch_setup):
        arch, cfg, model, params = arch_setup
        loss, g = _value_and_grad(model, params, _concrete_batch(cfg,
                                                                 "train"))
        new, _ = sgd_step(params, g, tree_zeros_like(params), 0.01, 0.9)
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(new)), arch
        changed = any(not torch.allclose(a.float(), b.float())
                      for a, b in zip(tree_leaves(params), tree_leaves(new),
                                      strict=True))
        assert changed, f"{arch}: no parameter moved"

    def test_loss_decreases_over_few_steps(self, arch_setup):
        arch, cfg, model, params = arch_setup
        batch = _concrete_batch(cfg, "train")
        buf = tree_zeros_like(params)
        losses = []
        for _ in range(8):
            loss, g = _value_and_grad(model, params, batch)
            params, buf = sgd_step(params, g, buf, 0.05, 0.9)
            losses.append(float(loss))
        assert losses[-1] < losses[0], f"{arch}: {losses}"


class TestSmokeServe:
    def test_prefill_then_decode_matches_shapes(self, arch_setup):
        arch, cfg, model, params = arch_setup
        batch = _concrete_batch(cfg, "prefill")
        if not cfg.supports_decode:
            with pytest.raises(ValueError, match="encoder-only"):
                model.prefill(params, batch, SEQ + 8)
            return
        logits, cache = model.prefill(params, batch, SEQ + 8)
        assert logits.shape == (BATCH, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), arch
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(2):
            logits, cache = model.decode_step(params, tok, cache)
            assert logits.shape == (BATCH, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all()), arch
            tok = logits[:, -1].argmax(-1)[:, None]

    def test_decode_consistent_with_prefill(self, arch_setup):
        """Prefill(t₀..tₙ) last logits == decode after
        prefill(t₀..tₙ₋₁)."""
        arch, cfg, model, params = arch_setup
        full = _concrete_batch(cfg, "prefill", seq=SEQ)
        if not cfg.supports_decode:
            with pytest.raises(ValueError, match="encoder-only"):
                model.decode_step(params, full["tokens"][:, -1:], {"pos": 0})
            return
        shorter = dict(full, tokens=full["tokens"][:, :-1])
        logits_full, _ = model.prefill(params, full, SEQ)
        _, cache = model.prefill(params, shorter, SEQ)
        logits_dec, _ = model.decode_step(params, full["tokens"][:, -1:],
                                          cache)
        np.testing.assert_allclose(logits_full[:, 0].numpy(),
                                   logits_dec[:, 0].numpy(), rtol=2e-2,
                                   atol=2e-2)

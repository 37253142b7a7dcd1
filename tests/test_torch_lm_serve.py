"""The port's LM serving path against the JAX package, on ``tiny()`` configs
with the JAX model's weights carried across by ``convert.load_lm_params``.

* Configs: the port's copies equal the JAX package's field for field, for
  all ten archs and their ``tiny()`` forms.
* Prefill: last-position logits within 1e-4 (float32: the tiny configs
  compute in float32, so only summation order differs) and every decode
  cache — ring-buffer KV, conv state, rglru ``h``, mamba ``ssm`` — within
  1e-5. The port takes ``h`` and ``ssm`` from its scan's last step; the JAX
  package recomputes them with a second scan, and the two agree to the same
  1e-5. Pairs: the port's
  ``impl="kernel"`` (CPU tensors: the kernels' plain versions) against the
  JAX ``impl="pallas"`` (interpret mode), and ``impl="torch"`` against
  ``impl="xla"``.
* Decode: 8 ``decode_step``s from the same cache (the JAX prefill's,
  carried across by ``lm_cache_from_numpy``) on the same tokens, logits
  within 1e-4 at every step.
* ``greedy_generate``: identical tokens.
* The port's own decode after prefill(S) equals its full forward at S+1
  within 2e-3, the JAX package's ``test_prefill_decode_parity`` bound.

Every arch runs (global and sliding-window attention, swiglu/gelu/relu2,
MoE, partial rotary, QK-norm, sandwich norms, ``embed_inputs``, RG-LRU,
Mamba). MoE archs check decode after prefill with a capacity that drops no
pair, as the JAX package's ``test_prefill_decode_parity`` does: which pairs
overflow depends on the tokens routed together.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import tiny as j_tiny
from repro.models import build_model as j_build_model
from repro.training.serve_step import greedy_generate as j_greedy_generate
from repro_torch import convert
from repro_torch.configs import get_config, list_archs, tiny
from repro_torch.models import build_model
from repro_torch.models.common import rms_norm
from repro_torch.training import greedy_generate
from _twin_config import PORT_ONLY_ARCHS, reference_fields

torch.backends.cuda.matmul.allow_tf32 = False

#: the port's archs with a twin in the JAX package (granite-4.0-h-small,
#: the port's own, trains only and is held against its plain reference in
#: ``test_torch_granite_hybrid.py``)
ARCHS = j_list_archs()
SERVED = ARCHS
IMPLS = [("kernel", "pallas"), ("torch", "xla")]
B, S, STEPS = 2, 12, 8
CACHE_LEN = S + STEPS


def _prompt(cfg, seed, length=S):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.standard_normal((B, length, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, length)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair(arch, port_impl="kernel", jax_impl="pallas"):
    """(cfg, JAX model, JAX params, port model) with the same weights; built
    once per module run (the tests read them and change nothing)."""
    cfg = tiny(get_config(arch))
    jmodel = j_build_model(j_tiny(j_get_config(arch)), impl=jax_impl)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = convert.load_lm_params(build_model(cfg, impl=port_impl, device="cpu"), jparams)
    return cfg, jmodel, jparams, model


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, dtype=np.float32)}


@pytest.mark.parametrize("form", ["full", "tiny"])
@pytest.mark.parametrize("arch", j_list_archs())
def test_configs_equal_field_for_field(arch, form):
    assert sorted(set(list_archs()) - set(j_list_archs())) == PORT_ONLY_ARCHS
    assert set(j_list_archs()) <= set(list_archs())
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    if form == "tiny":
        j_cfg, cfg = j_tiny(j_cfg), tiny(cfg)
    assert reference_fields(cfg) == dataclasses.asdict(j_cfg)
    assert cfg.layer_kinds() == j_cfg.layer_kinds()
    assert (cfg.num_periods, cfg.num_leftover) == (j_cfg.num_periods, j_cfg.num_leftover)


@pytest.mark.parametrize("impl", IMPLS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_logits_and_caches_match_jax(arch, impl):
    cfg, jmodel, jparams, model = _pair(arch, *impl)
    prompt = _prompt(cfg, seed=1)
    j_logits, j_cache = jax.jit(lambda p, x: jmodel.prefill(p, x, CACHE_LEN))(
        jparams, jnp.asarray(prompt))
    logits, caches = model.prefill(prompt, CACHE_LEN)
    assert logits.shape == (B, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    want = _leaves(jax.tree.map(np.asarray, j_cache))
    got = _leaves(convert.lm_cache_to_numpy(cfg, caches))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_steps_match_jax(arch):
    cfg, jmodel, jparams, model = _pair(arch, "torch", "xla")
    prompt = _prompt(cfg, seed=2)
    _, j_cache = jax.jit(lambda p, x: jmodel.prefill(p, x, CACHE_LEN))(
        jparams, jnp.asarray(prompt))
    caches = convert.lm_cache_from_numpy(cfg, jax.tree.map(np.asarray, j_cache),
                                         model.compute_dtype, "cpu")
    step = jax.jit(jmodel.decode_step)
    feed = _prompt(cfg, seed=3, length=STEPS)
    for i in range(STEPS):
        x = feed[:, i : i + 1] if cfg.embed_inputs else feed[:, i]
        j_logits, j_cache = step(jparams, j_cache, jnp.asarray(x), jnp.asarray(S + i, jnp.int32))
        logits, caches = model.decode_step(caches, x, S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4,
                                   err_msg=f"step {i}")
    want = _leaves(jax.tree.map(np.asarray, j_cache))
    got = _leaves(convert.lm_cache_to_numpy(cfg, caches))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("impl", IMPLS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("arch", SERVED)
def test_greedy_generate_matches_jax(arch, impl):
    cfg, jmodel, jparams, model = _pair(arch, *impl)
    prompt = _prompt(cfg, seed=4)
    want = np.asarray(j_greedy_generate(jmodel, jparams, jnp.asarray(prompt), STEPS, CACHE_LEN))
    got = greedy_generate(model, torch.as_tensor(prompt), STEPS, CACHE_LEN)
    assert got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_after_prefill_equals_forward(arch):
    """decode_step after prefill(S) must equal the full forward at S+1 — the
    port's twin of the JAX package's ``test_prefill_decode_parity``."""
    cfg, _, _, model = _pair(arch, "kernel", "pallas")
    if cfg.moe is not None:
        no_drop = dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.num_experts / cfg.moe.top_k) + 1.0)
        cfg = dataclasses.replace(cfg, moe=no_drop)
        model = build_model(cfg, impl="kernel", device="cpu").init(0)
    full = torch.as_tensor(_prompt(cfg, seed=5, length=S + 1))
    prompt, nxt = full[:, :S], (full[:, S:S + 1] if cfg.embed_inputs else full[:, S])
    with torch.inference_mode():
        positions = model._positions(B, S + 1)
        h, _ = model._backbone(model._embed(full), positions)
        h = rms_norm(h, model.final_norm, cfg.norm_eps)
        want = model._head(h[:, -1:, :]).float()[:, 0]
    _, caches = model.prefill(prompt, S + 8)
    got, _ = model.decode_step(caches, nxt, S)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-3)


def test_full_recurrentgemma_shapes_without_allocating():
    """The full config builds on the meta device: 38 layers, 26 rglru and
    12 swa, and the JAX package's parameter count, 7,483,805,696."""
    cfg = get_config("recurrentgemma-9b")
    model = build_model(cfg, device="cpu")
    assert model.embed.is_meta
    assert model.kinds.count("rglru") == 26 and model.kinds.count("swa") == 12
    assert model.kinds[:3] == ("rglru", "rglru", "swa") and model.kinds[-2:] == ("rglru", "rglru")
    abstract = j_build_model(j_get_config("recurrentgemma-9b")).abstract_params()
    j_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abstract))
    assert model.num_params() == j_count == 7_483_805_696


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("recurrentgemma-9b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tiny(get_config("recurrentgemma-9b")), impl="torch")


def test_seeded_init():
    """The same seed gives the same weights; the truncated normal stays in
    [−2, 2]·scale with the standard deviation of a normal truncated there
    (0.8796); zeros and constants are exact."""
    cfg = tiny(get_config("recurrentgemma-9b"))
    a = build_model(cfg, device="cpu").init(3)
    b = build_model(cfg, device="cpu").init(3)
    c = build_model(cfg, device="cpu").init(4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
    embed = a.embed / cfg.d_model**-0.5
    assert float(embed.abs().max()) <= 2.0
    assert abs(float(embed.std()) - 0.8796) < 0.01
    assert not torch.equal(a.embed, c.embed)
    assert torch.equal(a.blocks[0].mixer.lam, torch.full((64,), 0.65))
    assert float(a.blocks[0].ln1.abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown impl"):
        build_model(cfg, impl="pallas", device="cpu")

"""The port's MoE block against the JAX package's (``repro.models.mlp``).

* Routing: the top-k experts, each pair's capacity slot and the keep mask,
  equal to the JAX package's (its ``moe_fwd`` lines, run here in JAX) —
  on seeded inputs, with a capacity that overflows, and on tied
  probabilities (``jax.lax.top_k`` takes the lower expert first).
* ``moe_fwd`` and ``_moe_fwd_local``: outputs within 1e-5 and the aux loss
  within 1e-6 of the JAX package's in float32 (only summation order
  differs), for SwiGLU and GELU experts, with and without dropped pairs.
* Gradients of a seeded projection of the output plus the aux loss, with
  respect to x and every MoE weight, within 1e-5 of ``jax.grad``.
* The parameters carry across under the JAX package's names
  (``mlp.router``, ``mlp.w1``/``w2``/``w3``) and shapes.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny as j_tiny
from repro.distributed.sharding import ShardingRules
from repro.models import build_model as j_build_model
from repro.models.common import Builder, ShardCtx
from repro.models import mlp as j_mlp
from repro_torch import convert
from repro_torch.configs import get_config, tiny
from repro_torch.models import build_model
from repro_torch.models import mlp as t_mlp
from repro_torch.models.common import ParamModule

torch.set_num_threads(1)

CTX = ShardCtx(ShardingRules(), None)
ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")


def _cfgs(arch, **moe):
    """(JAX config, port config) of ``tiny(arch)`` with MoE fields replaced."""
    j_cfg, cfg = j_tiny(j_get_config(arch)), tiny(get_config(arch))
    if moe:
        j_cfg = dataclasses.replace(j_cfg, moe=dataclasses.replace(j_cfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return j_cfg, cfg


def _params(j_cfg, cfg, seed=0):
    """The JAX package's MoE parameters (numpy) and the port's module
    (declared from the port's config) holding the same values."""
    b = Builder("init", jax.random.PRNGKey(seed), ShardingRules(), None, jnp.float32)
    jp = jax.tree.map(np.asarray, j_mlp.moe_params(b.scope("moe"), j_cfg))
    p = t_mlp.moe_params(cfg)
    p.to_empty(device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    return jp, p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_route(x, router, k, capacity):
    """The routing lines of the JAX package's ``moe_fwd``
    (``src/repro/models/mlp.py``), on (T, D) tokens."""
    logits = jnp.einsum("td,de->te", x, router).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    e = router.shape[1]
    e_flat = top_e.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_all, e_flat[:, None], axis=1)[:, 0]
    keep = pos < capacity
    return np.asarray(top_e), np.asarray(jnp.minimum(pos, capacity - 1)), np.asarray(keep)


@pytest.mark.parametrize("case", ["seeded", "overflow", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_equals_jax(arch, case):
    j_cfg, cfg = _cfgs(arch, capacity_factor=0.5 if case == "overflow" else 1.25)
    jp, _ = _params(j_cfg, cfg)
    t, k, e = 48, cfg.moe.top_k, cfg.moe.num_experts
    x = _x((t, cfg.d_model))
    router = np.array(jp["router"])
    if case == "ties":
        x[::3] = 0.0  # uniform probabilities: every expert tied
        router[:, 1] = router[:, 0]  # experts 0 and 1 tied on every token
    capacity = int(math.ceil(t * k / e * cfg.moe.capacity_factor))
    want = _jax_route(jnp.asarray(x), jnp.asarray(router), k, capacity)
    probs = torch.softmax((torch.from_numpy(x) @ torch.from_numpy(router)).float(), -1)
    _, top_e, pos, keep = t_mlp.route(probs[None], k, capacity)
    np.testing.assert_array_equal(top_e[0].numpy(), want[0])
    np.testing.assert_array_equal(pos[0].numpy(), want[1])
    np.testing.assert_array_equal(keep[0].numpy(), want[2])
    if case == "overflow":
        assert not want[2].all()  # some pairs are dropped
    if case == "ties":
        assert (want[0][::3] == np.arange(k)).all()  # the lower experts first


def _forwards(j_cfg, cfg, jp, p, x, local):
    j_fn = j_mlp._moe_fwd_local if local else j_mlp.moe_fwd
    t_fn = t_mlp._moe_fwd_local if local else t_mlp.moe_fwd
    j_out, j_aux = j_fn(jnp.asarray(x), jax.tree.map(jnp.asarray, jp), j_cfg, CTX)
    out, aux = t_fn(torch.from_numpy(x), p, cfg)
    return (np.asarray(j_out), float(j_aux)), (out.detach().numpy(), float(aux))


@pytest.mark.parametrize("local", [False, True], ids=["allreduce", "local"])
@pytest.mark.parametrize("variant", ["swiglu", "gelu", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_matches_jax(arch, variant, local):
    moe = {"capacity_factor": 0.5} if variant == "overflow" else {}
    j_cfg, cfg = _cfgs(arch, **moe)
    if variant == "gelu":
        j_cfg, cfg = dataclasses.replace(j_cfg, mlp="gelu"), dataclasses.replace(cfg, mlp="gelu")
    jp, p = _params(j_cfg, cfg)
    x = _x((2, 12, cfg.d_model))
    (j_out, j_aux), (out, aux) = _forwards(j_cfg, cfg, jp, p, x, local)
    assert out.shape == j_out.shape == x.shape
    np.testing.assert_allclose(out, j_out, rtol=0, atol=1e-5)
    assert abs(aux - j_aux) <= 1e-6
    assert ("w3" in dict(p.named_parameters())) == (variant != "gelu")


@pytest.mark.parametrize("variant", ["seeded", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax(arch, variant):
    j_cfg, cfg = _cfgs(arch, capacity_factor=0.5 if variant == "overflow" else 1.25)
    jp, p = _params(j_cfg, cfg)
    x = _x((2, 12, cfg.d_model))
    cot = _x(x.shape, seed=7)

    def j_obj(x, params):
        out, aux = j_mlp.moe_fwd(x, params, j_cfg, CTX)
        return jnp.sum(out * cot) + aux

    j_gx, j_gp = jax.grad(j_obj, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, jp))
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in p.parameters():
        t.requires_grad_(True)
    out, aux = t_mlp.moe_fwd(xt, p, cfg)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx), rtol=0, atol=1e-5)
    for name, t in p.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_gp[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    # the router is reached only through the weights and the aux loss
    assert float(p.router.grad.abs().max()) > 0


def test_local_dispatch_is_global_without_a_mesh():
    """One batch shard (no mesh): per-shard capacity is the global one, so
    both dispatches give the same numbers bit for bit."""
    assert t_mlp._batch_ways() == 1
    j_cfg, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=0.5)
    _, p = _params(j_cfg, cfg)
    x = torch.from_numpy(_x((3, 8, cfg.d_model)))
    a, a_aux = t_mlp.moe_fwd(x, p, cfg)
    b, b_aux = t_mlp._moe_fwd_local(x, p, cfg)
    assert torch.equal(a, b) and torch.equal(a_aux, b_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_parameters_carry_under_jax_names(arch):
    """``convert`` carries the JAX package's ``p["mlp"]`` leaves unchanged;
    full configs give the JAX package's parameter counts."""
    j_cfg, cfg = _cfgs(arch)
    jparams = j_build_model(j_cfg).init(jax.random.PRNGKey(0))
    model = convert.load_lm_params(build_model(cfg, impl="torch", device="cpu"), jparams)
    mlp = model.blocks[1].mlp
    assert isinstance(mlp, ParamModule)
    for name in ("router", "w1", "w2", "w3"):
        want = np.asarray(jparams["stack"]["slot0_attn"]["mlp"][name])[1]
        np.testing.assert_array_equal(getattr(mlp, name).numpy(), want)
    full = build_model(get_config(arch), device="cpu")
    abstract = j_build_model(j_get_config(arch)).abstract_params()
    assert full.num_params() == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))

"""The port's training substrate against the JAX package's
(``repro.data``, ``repro.training``, ``Model.loss_fn``), on the CPU.

* Data: ``SyntheticLMDataset`` batches (token and embed modes) equal to the
  reference's bit for bit, and the reference's own data properties.
* Optimizer: ``lr_schedule`` (cosine, linear, constant), ``adamw_update``
  (float32 and bf16 first moments, with clipping active) and the
  reference's numpy AdamW check, within 1e-6 relative.
* Loss and step, for every arch's ``tiny()`` with the JAX init weights
  carried across: ``loss_fn``'s (loss, ce, aux) within 1e-5 of the
  reference's ``impl="xla"``; one ``make_train_step``'s metrics within 1e-5
  (``grad_norm`` relative: the port sums the parameters in another order)
  and parameters within 5e-4, the reference's own bound for two
  summation orders (``tests/test_training.py``: Adam divides by √v, which
  turns float32 rounding of a near-zero gradient into O(lr)). Two
  microbatches against the reference's two.
* Port-side properties: microbatch equivalence, remat changes no number,
  the loss falls and a restart from a checkpoint is bit-exact, checkpoints
  load across packages in both directions with equal arrays, and a model
  with ``impl="kernel"`` is refused.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import tiny as j_tiny
from repro.data import SyntheticLMDataset as JData
from repro.models import build_model as j_build_model
from repro.training import AdamWConfig as JAdamW
from repro.training import adamw_init as j_adamw_init
from repro.training import adamw_update as j_adamw_update
from repro.training import lr_schedule as j_lr_schedule
from repro.training import make_train_step as j_make_train_step
from repro.training.checkpoint import load_checkpoint as j_load_checkpoint
from repro.training.checkpoint import save_checkpoint as j_save_checkpoint
from repro.training.train_step import init_train_state as j_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config, tiny
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.training import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
    make_eval_step,
    make_train_step,
)
from repro_torch.training.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_step import init_train_state, train_state_of

torch.set_num_threads(1)

OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _tree_leaves(tree, prefix=()):
    """{path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("embed_dim", [None, 32], ids=["tokens", "embed"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_equal_reference(seed, embed_dim):
    a = SyntheticLMDataset(512, 16, 4, seed=seed, embed_dim=embed_dim)
    b = JData(512, 16, 4, seed=seed, embed_dim=embed_dim)
    for step in (0, 3, 10_000):
        got, want = a.batch(step), b.batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(next(iter(a))["inputs"], a.batch(0)["inputs"])


def test_synthetic_data_properties():
    """The reference's ``TestSyntheticData`` cases on the port's copy."""
    ds = SyntheticLMDataset(512, 16, 4, seed=7)
    np.testing.assert_array_equal(ds.batch(3)["inputs"],
                                  SyntheticLMDataset(512, 16, 4, seed=7).batch(3)["inputs"])
    assert not np.array_equal(ds.batch(0)["inputs"], ds.batch(1)["inputs"])
    b = SyntheticLMDataset(512, 16, 4, seed=0).batch(0)
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    e = SyntheticLMDataset(512, 16, 4, seed=0, embed_dim=32).batch(0)
    assert e["inputs"].shape == (4, 16, 32) and e["inputs"].dtype == np.float32
    ds = SyntheticLMDataset(256, 64, 8, seed=0)
    b = ds.batch(0)
    assert np.mean(ds._perm[b["inputs"]] == b["labels"]) > 0.85


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=7, total_steps=60, min_lr_ratio=0.1,
              schedule=schedule)
    cfg, j_cfg = AdamWConfig(**kw), JAdamW(**kw)
    for s in (0, 1, 6, 7, 8, 23, 33, 59, 60, 80):
        got = lr_schedule(torch.tensor(s, dtype=torch.int32), cfg)
        want = j_lr_schedule(jnp.asarray(s, jnp.int32), j_cfg)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-6, (schedule, s)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "z": np.zeros((3,), np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1e9, 0.5], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(moment_dtype, clip_norm):
    kw = dict(learning_rate=1e-2, beta2=0.98, weight_decay=0.1, clip_norm=clip_norm,
              warmup_steps=2, total_steps=8, moment_dtype=moment_dtype)
    cfg, j_cfg = AdamWConfig(**kw), JAdamW(**kw)
    params = _opt_tree(0)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_adamw_init(j_params, j_cfg)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = adamw_init(t_params, cfg)
    assert t_state["m"]["w"].dtype == getattr(torch, moment_dtype)
    assert t_state["v"]["w"].dtype == torch.float32
    for step in range(5):
        grads = _opt_tree(10 + step)
        j_params, j_state, j_m = j_adamw_update(j_params, jax.tree.map(jnp.asarray, grads),
                                                j_state, j_cfg)
        t_params, t_state, t_m = adamw_update(
            t_params, {k: torch.from_numpy(v) for k, v in grads.items()}, t_state, cfg)
        assert _rel(t_m["lr"].numpy(), j_m["lr"]) <= 1e-6
        assert _rel(t_m["grad_norm"].numpy(), j_m["grad_norm"]) <= 1e-6
        for k in params:
            assert _rel(t_params[k].numpy(), j_params[k]) <= 1e-6, (step, k)
            assert _rel(t_state["m"][k].float().numpy(),
                        np.asarray(j_state["m"][k], np.float32)) <= 1e-6, (step, k)
            assert _rel(t_state["v"][k].numpy(), j_state["v"][k]) <= 1e-6, (step, k)
        assert int(t_state["step"]) == int(j_state["step"]) == step + 1


def test_adamw_matches_numpy_reference_and_clips():
    """The reference's numpy AdamW check and its clipping check."""
    cfg = AdamWConfig(learning_rate=1e-2, beta1=0.9, beta2=0.999, weight_decay=0.1,
                      clip_norm=1e9, warmup_steps=1, total_steps=10, schedule="constant")
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    new_p, _, _ = adamw_update(params, {"w": torch.tensor([0.1, 0.2, -0.3])},
                               adamw_init(params, cfg), cfg)
    g, p = np.asarray([0.1, 0.2, -0.3]), np.asarray([1.0, -2.0, 3.0])
    mhat, vhat = (0.1 * g) / (1 - 0.9), (0.001 * g * g) / (1 - 0.999)
    want = p - 1e-2 * (mhat / (np.sqrt(vhat) + 1e-8) + 0.1 * p)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)
    cfg = AdamWConfig(clip_norm=0.5, weight_decay=0.0, warmup_steps=1, schedule="constant")
    params = {"w": torch.zeros(3)}
    _, _, metrics = adamw_update(params, {"w": torch.tensor([30.0, 40.0, 0.0])},
                                 adamw_init(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(50.0, rel=1e-6)
    assert float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})) == 5.0


# ------------------------------------------------------------ loss and step
def _pair(arch, microbatches=None):
    """(cfg, JAX model, JAX TrainState, port model, port TrainState): the
    same tiny model in both packages, the JAX init weights carried across."""
    j_cfg, cfg = j_tiny(j_get_config(arch)), tiny(get_config(arch))
    if microbatches is not None:
        j_cfg = dataclasses.replace(j_cfg, microbatches=microbatches)
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    jmodel = j_build_model(j_cfg)
    j_state = j_init_train_state(jmodel, jax.random.PRNGKey(0), JAdamW(**OPT))
    model = convert.load_lm_params(build_model(cfg, impl="torch", device="cpu"),
                                   jax.tree.map(np.asarray, j_state.params))
    return cfg, jmodel, j_state, model, train_state_of(model, AdamWConfig(**OPT))


def _batch(cfg, step=0, batch=4):
    ds = SyntheticLMDataset(cfg.vocab_size, 16, batch, seed=0,
                            embed_dim=cfg.d_model if cfg.embed_inputs else None)
    return ds.batch(step)


def _check_step(cfg, j_out, t_out):
    (j_state, j_met), (t_state, t_met) = j_out, t_out
    for key in ("loss", "ce", "aux", "lr"):
        assert abs(float(t_met[key]) - float(j_met[key])) <= 1e-5, key
    assert _rel(float(t_met["grad_norm"]), float(j_met["grad_norm"])) <= 1e-5
    got = _tree_leaves(convert.lm_params_to_numpy(cfg, t_state.params))
    want = _tree_leaves(jax.tree.map(np.asarray, j_state.params))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=5e-4, err_msg=str(path))
    assert int(t_state.opt["step"]) == int(j_state.opt["step"]) == 1


@pytest.mark.parametrize("arch", j_list_archs())
def test_loss_and_train_step_match_reference(arch):
    cfg, jmodel, j_state, model, state = _pair(arch)
    batch = _batch(cfg)
    j_loss, j_met = jax.jit(jmodel.loss_fn)(j_state.params, jax.tree.map(jnp.asarray, batch))
    loss, met = model.loss_fn(batch)
    assert loss.dtype == torch.float32 and loss.requires_grad
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    for key in ("ce", "aux"):
        assert abs(float(met[key]) - float(j_met[key])) <= 1e-5, key
    assert (float(met["aux"]) > 0) == (cfg.moe is not None)
    j_out = jax.jit(j_make_train_step(jmodel, JAdamW(**OPT)))(
        j_state, jax.tree.map(jnp.asarray, batch))
    _check_step(cfg, j_out, make_train_step(model, AdamWConfig(**OPT))(state, batch))


def test_two_microbatches_match_reference():
    """Contiguous (2, B/2) chunks, float32 accumulation, ce = loss − mean
    aux: the MoE arch, whose capacity depends on the tokens routed
    together, so a different split would route differently."""
    cfg, jmodel, j_state, model, state = _pair("granite-moe-1b-a400m", microbatches=2)
    batch = _batch(cfg, step=1)
    j_out = jax.jit(j_make_train_step(jmodel, JAdamW(**OPT)))(
        j_state, jax.tree.map(jnp.asarray, batch))
    _check_step(cfg, j_out, make_train_step(model, AdamWConfig(**OPT))(state, batch))


def test_microbatch_equivalence():
    """The twin of the reference's ``test_microbatch_equivalence``."""
    cfg = tiny(get_config("qwen2.5-3b"))
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    m1 = build_model(cfg, impl="torch", device="cpu")
    m2 = build_model(dataclasses.replace(cfg, microbatches=4), impl="torch", device="cpu")
    s1, s2 = init_train_state(m1, 0, opt), init_train_state(m2, 0, opt)
    batch = SyntheticLMDataset(cfg.vocab_size, 16, 8, seed=0).batch(0)
    n1, met1 = make_train_step(m1, opt)(s1, batch)
    n2, met2 = make_train_step(m2, opt)(s2, batch)
    assert float(met1["loss"]) == pytest.approx(float(met2["loss"]), abs=1e-5)
    for k in n1.params:
        np.testing.assert_allclose(n1.params[k].detach().numpy(),
                                   n2.params[k].detach().numpy(), atol=5e-4, err_msg=k)


def test_remat_and_eval_step_change_no_number():
    """``cfg.remat`` recomputes each period in the backward: the same loss
    and gradients bit for bit; ``make_eval_step`` is ``loss_fn`` without
    gradients."""
    cfg = tiny(get_config("recurrentgemma-9b"))  # a period of 3 + a leftover layer
    batch = _batch(cfg)
    grads = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat), impl="torch",
                            device="cpu").init(3)
        params = train_state_of(model, AdamWConfig()).params
        loss, _ = model.loss_fn(batch)
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, list(params.values())))
        out = make_eval_step(model)(batch)
        assert not out["loss"].requires_grad and torch.equal(out["loss"], loss.detach())
    assert torch.equal(grads[True][0], grads[False][0])
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)


def test_loss_decreases_and_restart_is_bit_exact(tmp_path):
    """The twin of the reference's test of the same name: 20 steps, a
    checkpoint after step 9, a fresh model restored from it replays steps
    10–19 to the same parameters, moments and step, bit for bit."""
    cfg = tiny(get_config("qwen2.5-3b"))
    opt = AdamWConfig(learning_rate=5e-3, warmup_steps=5, total_steps=40)
    model = build_model(cfg, impl="torch", device="cpu")
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt)
    ds = SyntheticLMDataset(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for i in range(20):
        state, metrics = step(state, ds.batch(i))
        losses.append(float(metrics["loss"]))
        if i == 9:
            save_checkpoint(str(tmp_path), 9, state, {"loss": losses[-1]}, cfg=cfg)
    assert losses[-1] < losses[0] - 0.5, f"no learning: {losses[0]} -> {losses[-1]}"
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000009.json", "ckpt_00000009.npz"]

    other = build_model(cfg, impl="torch", device="cpu").init(1)
    restored, meta = load_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                                     train_state_of(other, opt), cfg=cfg)
    assert meta == {"step": 9, "extra": {"loss": losses[9]}}
    assert int(restored.opt["step"]) == 10
    replay = make_train_step(other, opt)
    for i in range(10, 20):
        restored, _ = replay(restored, ds.batch(i))
    for k in state.params:
        assert torch.equal(state.params[k], restored.params[k]), k
        assert torch.equal(state.opt["m"][k], restored.opt["m"][k]), k
        assert torch.equal(state.opt["v"][k], restored.opt["v"][k]), k
    assert int(state.opt["step"]) == int(restored.opt["step"]) == 20
    assert latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoints_load_across_packages(tmp_path, moment_dtype):
    """A stacked arch with a leftover layer: the reference's checkpoint
    loads into the port and the port's into the reference, every array
    equal."""
    arch = "recurrentgemma-9b"
    opt = dict(OPT, moment_dtype=moment_dtype)
    cfg, jmodel, j_state, model, state = _pair(arch)
    state = train_state_of(model, AdamWConfig(**opt))
    j_state = j_state._replace(opt=j_adamw_init(j_state.params, JAdamW(**opt)))
    batch = _batch(cfg)
    j_state, _ = jax.jit(j_make_train_step(jmodel, JAdamW(**opt)))(
        j_state, jax.tree.map(jnp.asarray, batch))
    state, _ = make_train_step(model, AdamWConfig(**opt))(state, batch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save_checkpoint(jdir, 1, j_state)
    save_checkpoint(tdir, 1, state, cfg=cfg)

    # reference → port
    fresh = train_state_of(build_model(cfg, impl="torch", device="cpu").init(5),
                           AdamWConfig(**opt))
    got, _ = load_checkpoint(jdir, 1, fresh, cfg=cfg)
    want = {".params": jax.tree.map(np.asarray, j_state.params),
            ".opt/m": jax.tree.map(lambda a: np.asarray(a, np.float32), j_state.opt["m"]),
            ".opt/v": jax.tree.map(np.asarray, j_state.opt["v"])}
    for key, tensors in ((".params", got.params), (".opt/m", got.opt["m"]),
                         (".opt/v", got.opt["v"])):
        mine = _tree_leaves(convert.lm_params_to_numpy(cfg, tensors))
        theirs = _tree_leaves(want[key])
        assert sorted(mine) == sorted(theirs)
        for path in theirs:
            np.testing.assert_array_equal(mine[path], theirs[path], err_msg=f"{key} {path}")
    assert got.opt["m"][next(iter(got.opt["m"]))].dtype == getattr(torch, moment_dtype)
    assert int(got.opt["step"]) == 1

    # port → reference
    template = jax.eval_shape(lambda: j_state)
    j_got, meta = j_load_checkpoint(tdir, 1, template)
    assert meta["step"] == 1
    mine = _tree_leaves({"params": convert.lm_params_to_numpy(cfg, state.params),
                         "opt": convert.opt_state_to_numpy(cfg, state.opt)})
    theirs = _tree_leaves({"params": jax.tree.map(np.asarray, j_got.params),
                           "opt": jax.tree.map(lambda a: np.asarray(a, np.float32)
                                               if a.dtype == jnp.bfloat16 else np.asarray(a),
                                               j_got.opt)})
    assert sorted(mine) == sorted(theirs)
    for path in theirs:
        np.testing.assert_array_equal(mine[path], theirs[path], err_msg=str(path))
    assert j_got.opt["m"]["embed"].dtype == jnp.dtype(moment_dtype)


def test_optimizer_state_carries_across_packages():
    """``convert.opt_state_from_numpy`` takes the reference's AdamW state
    (after a step, bf16 first moments) onto the port's names, and
    ``opt_state_to_numpy`` gives it back, every array equal."""
    arch = "recurrentgemma-9b"
    opt = dict(OPT, moment_dtype="bfloat16")
    cfg, jmodel, j_state, _, _ = _pair(arch)
    j_state = j_state._replace(opt=j_adamw_init(j_state.params, JAdamW(**opt)))
    j_state, _ = jax.jit(j_make_train_step(jmodel, JAdamW(**opt)))(
        j_state, jax.tree.map(jnp.asarray, _batch(cfg)))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), j_state.opt)
    port = convert.opt_state_from_numpy(cfg, tree, "cpu", moment_dtype="bfloat16")
    assert port["m"]["blocks.3.mixer.w_x"].dtype == torch.bfloat16
    assert port["v"]["embed"].dtype == torch.float32 and int(port["step"]) == 1
    back = _tree_leaves(convert.opt_state_to_numpy(cfg, port))
    want = _tree_leaves(tree)
    assert sorted(back) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(back[path], want[path], err_msg=str(path))


def test_kernel_impl_is_refused():
    cfg = tiny(get_config("granite-moe-1b-a400m"))
    model = build_model(cfg, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, AdamWConfig())
    model = build_model(cfg, impl="torch", device="cpu")
    state = init_train_state(model, 0, AdamWConfig())
    step = make_train_step(model, AdamWConfig())
    model.impl = "kernel"
    with pytest.raises(ValueError, match="impl='torch'"):
        step(state, _batch(cfg))
    model.impl = "torch"
    other = train_state_of(build_model(cfg, impl="torch", device="cpu").init(0), AdamWConfig())
    with pytest.raises(ValueError, match="own parameters"):
        step(other, _batch(cfg))

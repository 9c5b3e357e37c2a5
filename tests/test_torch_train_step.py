"""The port's training path (create_loss, create_optimizer,
create_train_state, make_loss_apply, build_train_step) against the JAX
package's, on one set of weights.

ViT-B-32-mini in fp32 with attn_impl='fusedp' on both sides (the JAX side
runs its Pallas kernels in interpret mode, the port its plain versions);
JAX's initial params cross over through `state_dict_from_flax`. Batch 8
from numpy seeds with repeated labels, AdamW at the bench's settings (lr
1e-4, wd 0.2, bf16 first moment), 3 steps each, for the dense and the
pallas loss. Each JAX step is built once per module.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu.parallel.train_step import _wd_mask as jax_wd_mask
from mrclip_tpu.train import scheduler as jax_sched
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.ops import pallas_loss
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (
    LOGIT_SCALE_MAX,
    build_eval_step,
    build_train_step,
    create_optimizer,
    create_train_state,
    make_loss_apply,
)
from mrclip_tpu_torch.parallel.train_step import _wd_mask, loss_and_grads
from mrclip_tpu_torch.train import scheduler

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

STEPS = 3


def _loss_args(pallas: bool):
    return SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=pallas,
                           model="ViT-B-32-mini", gather_with_grad=True)


@pytest.fixture(scope="module")
def jax_model():
    # initialised under 'xla' (the same tree; the interpret-mode kernels would
    # run the init forward op by op), then applied under 'fusedp'
    jm, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla")
    return jm.clone(attn_impl="fusedp"), jv


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8),
            rng.randint(1, 49408, (8, 32)).astype(np.int32),
            np.array([0, 1, 2, 0, 1, 0, 2, 2], np.int32))  # repeated labels


@pytest.fixture(scope="module", params=["dense", "pallas"])
def runs(request, jax_model):
    """Both sides from the same weights and batch: first-step gradients,
    per-step metrics over STEPS steps, final parameters."""
    pallas = request.param == "pallas"
    jm, jv = jax_model
    images, tokens, labels = _batch()

    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = jax_create_train_state(jv, tx)
    jax_apply = jax_make_loss_apply(jax_create_loss(_loss_args(pallas)))
    step = jax_build_train_step(jm, jax_apply, tx, donate=False)
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}

    def jax_loss(params):
        out = jm.apply({"params": params}, jb["images"], jb["tokens"], deterministic=False)
        return jax_apply(out, jb)["loss"]

    jax_grads = state_dict_from_flax(jax.device_get(jax.jit(jax.grad(jax_loss))(state.params)))
    jax_metrics = []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    jax_params = state_dict_from_flax(jax.device_get(state.params))

    model = create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                         device="cpu", attn_impl="fusedp")
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstate = create_train_state(model, ptx)
    apply = make_loss_apply(create_loss(_loss_args(pallas)))
    pstep = build_train_step(model, apply, ptx)
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    port_grads, _ = loss_and_grads(model, apply, pstate.params, pb)
    port_metrics = []
    for _ in range(STEPS):
        pstate, m = pstep(pstate, pb, torch.Generator().manual_seed(0))
        port_metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return dict(jax_grads=jax_grads, port_grads=port_grads, jax_metrics=jax_metrics,
                port_metrics=port_metrics, jax_params=jax_params, state=pstate, model=model)


def test_loss_and_grad_norm_match_per_step(runs):
    """fp32 through two layers each way: 1e-5 relative."""
    for (jl, jn), (pl_, pn) in zip(runs["jax_metrics"], runs["port_metrics"]):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)
    assert runs["port_metrics"][-1][0] < runs["port_metrics"][0][0]  # it learns


def test_first_step_gradients_match(runs):
    """rtol 1e-4 and atol 5e-6: the positional and token embedding tables sum
    256 (sample, position) contributions of size up to 3, where fp32
    summation order leaves up to 3.2e-6 (measured); elsewhere the two stay
    within 3e-7."""
    jg, pg = runs["jax_grads"], runs["port_grads"]
    assert set(pg) == set(jg)
    for name, g in pg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=1e-4, atol=5e-6,
                                   err_msg=name)
    # the attention projections learn (the fusedp backward reaches them)
    assert pg["visual.transformer.resblocks.0.attn.in_proj_weight"].abs().max() > 0


def test_params_after_three_steps_match(runs):
    """One Adam step moves a parameter by at most about lr = 1e-4; 2e-5 (a
    fifth of that) covers fp32 summation order and a flipped bf16 rounding
    of the first moment."""
    state, jp = runs["state"], runs["jax_params"]
    assert state.step == STEPS and state.opt_state.count == STEPS
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    assert runs["model"].training


def test_pallas_loss_step_goes_through_the_kernel_wrappers(monkeypatch):
    """Under pallas_loss a step calls each K6/K7 wrapper twice (once per
    direction); on the CPU the wrappers run their plain versions and count
    no launch."""
    calls = {name: 0 for name in pallas_loss.launches}
    for name in calls:
        real = getattr(pallas_loss, name)

        def wrapped(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(pallas_loss, name, wrapped)
    model = create_model("ViT-B-32-mini", device="cpu", attn_impl="fusedp")
    images, tokens, labels = _batch()
    tx = create_optimizer(lr=1e-4)
    step = build_train_step(model, make_loss_apply(create_loss(_loss_args(True))), tx)
    pallas_loss.reset_launches()
    _, m = step(create_train_state(model, tx),
                {"images": normalize_images(torch.from_numpy(images)),
                 "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    assert np.isfinite(m["loss"].item()) and set(m) >= {"loss", "grad_norm", "image_to_text_loss"}
    assert calls == {name: 2 for name in calls}
    assert sum(pallas_loss.launches.values()) == 0


def test_wd_mask_matches_jax(jax_model):
    _, jv = jax_model
    want = state_dict_from_flax(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                             jax_wd_mask(jv["params"]), jv["params"]))
    model = create_model("ViT-B-32-mini", device="cpu")
    got = _wd_mask(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, decay in got.items():
        assert decay == bool(want[name].flatten()[0]), name
    assert not got["logit_scale"] and got["visual.conv1.weight"] and not got["ln_final.weight"]


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_lr(1e-3, 10, 100),
    lambda m: m.const_lr(1e-3, 10, 100),
    lambda m: m.const_lr_cooldown(1e-3, 10, 100, 30, 2.0, 1e-5),
    lambda m: m.create_scheduler(SimpleNamespace(lr=2e-3, warmup=5, lr_scheduler="const-cooldown",
                                                 epochs_cooldown=2, epochs=4), 100),
])
def test_scheduler_values_match_jax(make):
    """JAX evaluates the schedules in fp32, the port in double: 1e-6
    relative, and 1e-9 absolute (1e-6 of the base lr) where the cosine
    nears zero."""
    got, want = make(scheduler), make(jax_sched)
    for step in (0, 3, 9, 10, 11, 40, 69, 70, 71, 99):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("clip,lr", [(None, 1e-3), (0.5, "cosine")])
def test_optimizer_matches_optax(moments_dtype, clip, lr):
    """AdamW on a small tree (a matrix, a bias, a logit scale) over 4 steps
    against optax.adamw with the same mask, clip and schedule; the bf16
    first moment rounds where optax rounds it."""
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(16, 8).astype(np.float32), "b": rng.randn(8).astype(np.float32),
            "logit_scale": np.float32(2.0)}
    grads = [{k: np.asarray(rng.randn(*np.shape(v)) * 3, np.float32) for k, v in init.items()}
             for _ in range(4)]
    lr_port = scheduler.cosine_lr(1e-3, 2, 10) if lr == "cosine" else lr
    lr_jax = jax_sched.cosine_lr(1e-3, 2, 10) if lr == "cosine" else lr
    jtx = jax_create_optimizer(lr=lr_jax, grad_clip_norm=clip, moments_dtype=moments_dtype)
    jp = jax.tree.map(jnp.asarray, init)
    jstate = jtx.init(jp)
    tx = create_optimizer(lr=lr_port, grad_clip_norm=clip, moments_dtype=moments_dtype)
    params = {k: torch.tensor(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        state = tx.update({k: torch.tensor(v) for k, v in g.items()}, state, params)
    for k in init:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    adam = jstate[-1][0] if clip else jstate[0]
    for k in init:
        np.testing.assert_allclose(state.mu[k].float().numpy(),
                                   np.asarray(adam.mu[k], np.float32), rtol=1e-6, atol=1e-9)
        assert state.mu[k].dtype == (torch.bfloat16 if moments_dtype else torch.float32)


def test_logit_scale_is_clamped():
    model = create_model("ViT-B-32-mini", device="cpu")
    with torch.no_grad():
        model.logit_scale.fill_(LOGIT_SCALE_MAX + 0.5)
    images, tokens, labels = _batch()
    tx = create_optimizer(lr=1e-4)
    step = build_train_step(model, make_loss_apply(create_loss(_loss_args(False))), tx)
    state, _ = step(create_train_state(model, tx),
                    {"images": normalize_images(torch.from_numpy(images)),
                     "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    assert state.params["logit_scale"].item() == pytest.approx(LOGIT_SCALE_MAX, abs=1e-6)
    assert state.params["logit_scale"] is model.logit_scale  # updated in place


def test_eval_step_returns_features_in_eval_mode():
    model = create_model("ViT-B-32-mini", device="cpu").train()
    images, tokens, _ = _batch()
    out = build_eval_step(model)({"images": normalize_images(torch.from_numpy(images)),
                                  "tokens": torch.from_numpy(tokens)})
    assert not model.training
    assert out["image_features"].shape == (8, 64) and not out["image_features"].requires_grad


@pytest.mark.parametrize("call", [
    lambda m, a, tx: build_train_step(m, a, tx, accum_freq=2),
    lambda m, a, tx: build_train_step(m, a, tx, cached_features_accum=True),
    lambda m, a, tx: build_train_step(m, a, tx, mesh=object()),
    lambda m, a, tx: create_train_state(m, tx, mesh=object()),
    lambda m, a, tx: make_loss_apply(create_loss(_loss_args(False)), mesh=object()),
    lambda m, a, tx: create_optimizer(lr=1e-4, opt="lion"),
    lambda m, a, tx: create_optimizer(lr=1e-4, opt="sgd"),
    lambda m, a, tx: create_optimizer(lr=1e-4, opt="adafactor"),
    lambda m, a, tx: create_model("ViT-B-32-mini", device="cpu", grad_checkpointing=True),
])
def test_refusals_name_their_roadmap_slice(call):
    model = create_model("ViT-B-32-mini", device="cpu")
    apply = make_loss_apply(create_loss(_loss_args(False)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(model, apply, create_optimizer(lr=1e-4))


def test_unknown_loss_has_no_adapter():
    with pytest.raises(ValueError, match="No loss adapter"):
        make_loss_apply(lambda *a: {})

"""The port's sgd, lion and adafactor (`parallel/optim.py`) against optax
0.2.6 through the JAX package's `create_optimizer`, the update mask
(`parallel/freeze.py`) against the JAX package's `build_trainable_mask` and
`chain_with_mask`, and checkpoint resume for every optimizer.

Each optimizer runs 3 steps on the same numpy-seeded tree: standalone
tensors wide enough for Adafactor to factor ([256, 384], [3, 128, 192]),
one where only one dim is that wide ([130, 8]), a vector, a matrix whose
name excludes it from weight decay and the logit scale; with a constant
learning rate and with a schedule under a global-norm clip.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mrclip_tpu.models.clip as jax_clip
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel.freeze import build_trainable_mask as jax_build_trainable_mask
from mrclip_tpu.parallel.freeze import chain_with_mask as jax_chain_with_mask
from mrclip_tpu.train import scheduler as jax_sched
from mrclip_tpu_torch import checkpoint as ckpt
from mrclip_tpu_torch import create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.models import clip as port_clip
from mrclip_tpu_torch.parallel import create_optimizer, create_train_state
from mrclip_tpu_torch.parallel.freeze import build_trainable_mask, chain_with_mask
from mrclip_tpu_torch.train import scheduler

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

STEPS = 3
SHAPES = {"w": (256, 384), "conv": (3, 128, 192), "narrow": (130, 8), "b": (64,),
          "bn_scale": (16, 16), "logit_scale": ()}


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*s), np.float32) for k, s in SHAPES.items()}


def _grads(seed=1):
    rng = np.random.RandomState(seed)
    return [{k: np.asarray(rng.randn(*s) * 2, np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)]


def _run_both(opt, *, clip=None, schedule=False, moments_dtype=None, mask=None):
    """(port params, port state, optax params, optax state) after STEPS steps."""
    lr_port = scheduler.cosine_lr(3e-3, 1, 10) if schedule else 3e-3
    lr_jax = jax_sched.cosine_lr(3e-3, 1, 10) if schedule else 3e-3
    kw = dict(wd=0.2, grad_clip_norm=clip, opt=opt, moments_dtype=moments_dtype)
    jtx = jax_create_optimizer(lr=lr_jax, **kw)
    tx = create_optimizer(lr=lr_port, **kw)
    if mask is not None:
        jtx = jax_chain_with_mask(jtx, {k: np.float32(mask[k]) for k in SHAPES})
        tx = chain_with_mask(tx, mask)
    init = _tree()
    jp = jax.tree.map(jnp.asarray, init)
    jstate = jtx.init(jp)
    params = {k: torch.tensor(v) for k, v in init.items()}
    state = tx.init(params)
    for g in _grads():
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        state = tx.update({k: torch.tensor(v) for k, v in g.items()}, state, params)
    return params, state, jp, jstate


def _inner(jstate, clip, cls):
    """The optax state of type `cls` inside a (clipped, chained) state."""
    found = [s for s in jax.tree.leaves(jstate, is_leaf=lambda x: isinstance(x, cls))
             if isinstance(s, cls)]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("clip,schedule", [(None, False), (0.5, True)])
@pytest.mark.parametrize("opt", ["sgd", "adafactor"])
def test_sgd_and_adafactor_match_optax(opt, clip, schedule):
    """Parameters and every state tensor to 1e-6 relative (1e-8 absolute)
    after 3 steps: the same operations in the same order; the reductions
    (Adafactor's means, the block and global norms) sum in another order."""
    params, state, jp, jstate = _run_both(opt, clip=clip, schedule=schedule)
    for k in SHAPES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    assert state.count == STEPS
    if opt == "sgd":
        trace = _inner(jstate, clip, optax.TraceState).trace
        for k in SHAPES:
            np.testing.assert_allclose(state.trace[k].numpy(), np.asarray(trace[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        return
    fs = _inner(jstate, clip, optax.FactoredState)
    assert int(fs.count) == STEPS
    for field in ("v_row", "v_col", "v"):
        for k in SHAPES:
            want, got = np.asarray(getattr(fs, field)[k]), getattr(state, field)[k].numpy()
            assert got.shape == want.shape, (field, k)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30, err_msg=f"{field} {k}")
    # the factored shapes hold row and column statistics, the others the full v
    assert state.v_row["w"].shape == (256,) and state.v_col["w"].shape == (384,)
    assert state.v_row["conv"].shape == (3, 128) and state.v_col["conv"].shape == (3, 192)
    assert state.v["narrow"].shape == (130, 8) and state.v["w"].shape == (1,)


def test_adafactor_decays_after_the_learning_rate():
    """optax adds the weight decay after the learning rate: at lr 0 a
    decayed weight still shrinks by wd = 0.2 of itself per step (the
    reference's behaviour, kept); the logit scale and the vector do not."""
    tx = create_optimizer(lr=0.0, wd=0.2, opt="adafactor")
    params = {k: torch.tensor(v) for k, v in _tree().items()}
    before = {k: v.clone() for k, v in params.items()}
    tx.update({k: torch.tensor(v) for k, v in _grads()[0].items()}, tx.init(params), params)
    torch.testing.assert_close(params["w"], before["w"] * 0.8, rtol=1e-6, atol=0)
    assert torch.equal(params["b"], before["b"]) and torch.equal(params["logit_scale"],
                                                                 before["logit_scale"])


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("clip,schedule", [(None, False), (0.5, True)])
def test_lion_matches_optax(moments_dtype, clip, schedule):
    """Lion's update is a sign: where (1 - b1) g + b1 mu sits near 0, the
    two sides may round it to opposite signs, so parameters are compared by
    the share of elements that differ by more than 1e-6: at most 1e-4 (none
    here). mu: fp32 to 1e-6 relative; bf16 by the share of elements more
    than one bf16 rounding (2^-8 relative) apart, at most 1e-4 (1 of 98304
    under the clip: the global norm sums in another order, which moves one
    rounding of g), none more than 2^-5 apart."""
    params, state, jp, jstate = _run_both("lion", clip=clip, schedule=schedule,
                                          moments_dtype=moments_dtype)
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    differ = sum(int((np.abs(params[k].numpy() - np.asarray(jp[k])) > 1e-6).sum())
                 for k in SHAPES)
    assert differ / n <= 1e-4
    mu = _inner(jstate, clip, optax.ScaleByLionState).mu
    off = 0
    for k in SHAPES:
        assert state.mu[k].dtype == (torch.bfloat16 if moments_dtype else torch.float32)
        want, got = np.asarray(mu[k], np.float32), state.mu[k].float().numpy()
        if moments_dtype is None:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8, err_msg=k)
            continue
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        off += int((rel > 2**-8).sum())
        assert rel.max() <= 2**-5, k
    assert off / n <= 1e-4
    assert state.count == STEPS


@pytest.mark.parametrize("opt", ["adamw", "sgd", "lion", "adafactor"])
def test_masked_update_matches_chain_with_mask(opt):
    """A frozen tensor keeps its values exactly (weight decay included) and
    its optimizer state still moves; the trainable ones match optax under
    `chain_with_mask` as above."""
    mask = {k: 0.0 if k in ("w", "b") else 1.0 for k in SHAPES}
    params, state, jp, _ = _run_both(opt, mask=mask)
    init = _tree()
    for k in SHAPES:
        if mask[k] == 0.0:
            assert np.array_equal(params[k].numpy(), init[k]), k
        else:
            assert not np.array_equal(params[k].numpy(), init[k]), k
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    moments = {"adamw": "mu", "sgd": "trace", "lion": "mu", "adafactor": "v_row"}[opt]
    assert getattr(state, moments)["w"].abs().max() > 0  # the frozen tensor's state moved


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        create_optimizer(lr=1e-3, opt="rmsprop")


# -- the trainable mask against the JAX package's, per flag and model ---------

VIT_TEXT = dict(context_length=16, vocab_size=49408, width=64, heads=2, layers=4)
MASK_FLAGS = [
    dict(lock_image=True),
    dict(lock_image=True, lock_image_unlocked_groups=1),
    dict(lock_image=True, lock_image_unlocked_groups=3),
    dict(lock_text=True, lock_text_unlocked_layers=2),
    dict(lock_image=True, lock_text=True, lock_text_unlocked_layers=9),
    dict(freeze=True),
    dict(freeze=True, freezelast=True),
    dict(freeze=True, freezelast=3),
]


def _mask_models():
    """(name, JAX params, port params) with 4 text layers, unrolled on both
    sides: ViT-B-32-mini, a narrow MobileCLIP-S1, EVA02-B-16, ViT-B-16-SigLIP
    (its timm tower at 4 layers: both packages' `_TIMM_VIT_DIMS` patched
    while it is built; non-causal text, biased projection) and
    ViT-L-14-CLIPA (4 layers, no ln_pre); their trees only: the masks need
    no forward."""
    def vision(name, **kw):
        return {"vision_cfg": dict(get_model_config(name)["vision_cfg"], **kw)}

    siglip_text = dict(get_model_config("ViT-B-16-SigLIP")["text_cfg"], context_length=16,
                       vocab_size=1000, width=64, heads=2, layers=4)
    out = []
    for name, extra, text in (("ViT-B-32-mini", {}, VIT_TEXT),
                              ("EVA02-B-16", vision("EVA02-B-16", image_size=32), VIT_TEXT),
                              ("MobileCLIP-S1", vision("MobileCLIP-S1", image_size=64), VIT_TEXT),
                              ("ViT-B-16-SigLIP", vision("ViT-B-16-SigLIP", image_size=32),
                               siglip_text),
                              ("ViT-L-14-CLIPA", vision("ViT-L-14-CLIPA", image_size=28, layers=4),
                               dict(VIT_TEXT, pool_type="last", no_causal_mask=True))):
        saved = jax_clip._TIMM_VIT_DIMS["base"], port_clip._TIMM_VIT_DIMS["base"]
        jax_clip._TIMM_VIT_DIMS["base"] = port_clip._TIMM_VIT_DIMS["base"] = (768, 4, 12)
        try:
            jm, _ = jax_create_model(name, init_params=False, scan_layers=False,
                                     attn_impl="xla", text_cfg=text, **extra)
            size = extra.get("vision_cfg", {}).get("image_size", 64)
            shapes = jax.eval_shape(lambda jm=jm, size=size: jm.init(
                jax.random.key(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1, 16), jnp.int32)))
            model = create_model(name, device="cpu", init_params=False, text_cfg=text, **extra)
        finally:
            jax_clip._TIMM_VIT_DIMS["base"], port_clip._TIMM_VIT_DIMS["base"] = saved
        jparams = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
        out.append((name, jparams, dict(model.named_parameters())))
    return out


@pytest.fixture(scope="module")
def mask_models():
    return _mask_models()


@pytest.mark.parametrize("flags", MASK_FLAGS, ids=lambda f: ",".join(f"{k}={v}" for k, v in
                                                                     f.items()))
def test_trainable_mask_matches_jax(mask_models, flags):
    """Every parameter's mask value equals the JAX package's for the same
    flags, through the weights' name map."""
    args = SimpleNamespace(**flags)
    for name, jparams, params in mask_models:
        jmask = jax_build_trainable_mask(jparams, args)
        want = state_dict_from_flax(jax.tree.map(
            lambda m, p: np.broadcast_to(np.asarray(m, np.float32), np.shape(p)).copy(),
            jmask, jparams))
        got = build_trainable_mask(params, args)
        assert set(got) == set(want), name
        wrong = [k for k in got if got[k] != float(want[k].flatten()[0])]
        assert not wrong, (name, wrong[:5])
        assert 0.0 in got.values(), name


def test_no_flag_no_mask():
    model = create_model("ViT-B-32-mini", device="cpu", init_params=False)
    assert build_trainable_mask(dict(model.named_parameters()), SimpleNamespace()) is None
    tx = create_optimizer(lr=1e-3)
    assert chain_with_mask(tx, None) is tx


# -- checkpoint resume for each optimizer ----------------------------------------

@pytest.mark.parametrize("opt,moments", [("adamw", "bfloat16"), ("sgd", None),
                                         ("lion", "bfloat16"), ("adafactor", None)])
def test_checkpoint_resume_for_each_optimizer(tmp_path, opt, moments):
    """Two updates, save, restore into a fresh state of the same optimizer:
    the parameters, the count and every state tensor bit-equal, in their
    stored types; a checkpoint of another optimizer is refused."""
    model = create_model("ViT-B-32-mini", device="cpu")
    tx = create_optimizer(lr=1e-3, opt=opt, moments_dtype=moments)
    state = create_train_state(model, tx)
    rng = np.random.RandomState(0)
    for _ in range(2):
        grads = {n: torch.from_numpy(np.asarray(rng.randn(*p.shape), np.float32))
                 for n, p in state.params.items()}
        state = type(state)(step=state.step + 1, params=state.params,
                            opt_state=tx.update(grads, state.opt_state, state.params),
                            constants=state.constants)
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    other = create_train_state(create_model("ViT-B-32-mini", device="cpu", rng_seed=5), tx)
    back = ckpt.load_checkpoint(str(tmp_path), template=other)
    assert back.step == 2 and back.opt_state.count == 2
    for k, v in state.params.items():
        assert torch.equal(back.params[k], v), k
    for field in ("mu", "nu", "trace", "v_row", "v_col", "v"):
        saved = getattr(state.opt_state, field, None)
        if saved is None:
            continue
        for k, v in saved.items():
            got = getattr(back.opt_state, field)[k]
            assert got.dtype == v.dtype and torch.equal(got, v), (field, k)
    other_opt = "sgd" if opt != "sgd" else "lion"
    with pytest.raises(KeyError, match="optimizer state"):
        ckpt.load_checkpoint(str(tmp_path), template=create_train_state(
            create_model("ViT-B-32-mini", device="cpu"), create_optimizer(lr=1e-3, opt=other_opt)))

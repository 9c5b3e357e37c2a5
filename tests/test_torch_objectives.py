"""MR-CLIP's other objectives and model options in the port against the JAX
package, on the CPU in fp32: the TE/TR distance-weighted, vision-only,
lam, chunked, SigLIP and distill losses (and their helpers), the
vision-only and distill train steps, the frozen temperature, text dropout
and `create_model`'s force_* and init_params options.

Losses take B = 64, D = 32 unit features from numpy seeds (and the reference
goldens of tests/golden_losses.npz, from tests/gen_golden_losses.py):
values to 1e-5 relative, gradients with respect to the features, the
logit scale (and SigLIP's bias) to 1e-5 relative with an absolute floor of
1e-6 of the largest gradient. Models are ViT-B-32-mini; JAX's initial
parameters cross over through `state_dict_from_flax`. The train steps run
the port under 'fusedp' (the kernels' plain versions on the CPU) against
JAX under 'xla' (in fp32 the same attention), at
tests/test_torch_train_step.py's bars.
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.losses import contrastive as jc
from mrclip_tpu.losses import functional as jf
from mrclip_tpu.ops import fused_loss as jfl
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu.serving import export_model as jax_export_model
from mrclip_tpu.train.vision_only import build_vision_only_step as jax_vision_only_step
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.losses import contrastive as tc
from mrclip_tpu_torch.losses import functional as tf
from mrclip_tpu_torch.models.layers import dropout
from mrclip_tpu_torch.ops import fused_loss as tfl
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported
from mrclip_tpu_torch.train import build_vision_only_step

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

B, D = 64, 32
RTOL = 1e-5
STEPS = 3


def t(x):
    return torch.from_numpy(np.asarray(x))


def unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def g():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "golden_losses.npz"))


def te_tr(rng, n, scale):
    """TE in [10, 320] ms and TR in [300, 9600] ms, in seconds (scale 1) or
    in milliseconds (scale 1000)."""
    return (rng.uniform(0.010, 0.320, n).astype(np.float32) * scale,
            rng.uniform(0.300, 9.600, n).astype(np.float32) * scale)


def inputs(seed=0, classes=8):
    rng = np.random.RandomState(seed)
    img, txt, dimg, dtxt = (unit(rng, B, D) for _ in range(4))
    labels = rng.randint(0, classes, B).astype(np.int32)
    return dict(img=img, txt=txt, dimg=dimg, dtxt=dtxt, labels=labels, scale=np.float32(14.0),
                bias=np.float32(-10.0), dscale=np.float32(20.0))


def assert_grads_close(got, want, what):
    for name, (a, w) in enumerate(zip(got, want)):
        a, w = a.detach().numpy(), np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what}: gradient {name}")


def value_and_grads(port_fn, jax_fn, args, n_diff):
    """Loss dicts of both sides and the gradients of "loss" with respect to
    the first `n_diff` arguments."""
    targs = [t(a).clone().requires_grad_(i < n_diff) for i, a in enumerate(args)]
    got = port_fn(*targs)
    got["loss"].backward()
    jargs = [jnp.asarray(a) for a in args]
    want = jax_fn(*jargs)
    jgrads = jax.grad(lambda *d: jax_fn(*d, *jargs[n_diff:])["loss"],
                      argnums=tuple(range(n_diff)))(*jargs[:n_diff])
    return got, want, [a.grad for a in targs[:n_diff]], jgrads


# ---- the functional helpers against the goldens and JAX ----------------------


@pytest.mark.parametrize("name", ["weighted_euclidean", "mahalanobis"])
def test_distances_match_golden_and_jax(g, name):
    args = (g["te"], g["tr"], g["all_te"], g["all_tr"])
    got = getattr(tf, f"{name}_distance")(*(t(a) for a in args))
    want = getattr(jf, f"{name}_distance")(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), g[name], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["weighted_euclidean", "mahalanobis"])
@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_distances_match_jax_at_both_te_tr_scales(name, scale):
    rng = np.random.RandomState(1)
    te, tr = te_tr(rng, B, scale)
    all_te, all_tr = te_tr(rng, 2 * B, scale)
    got = getattr(tf, f"{name}_distance")(t(te), t(tr), t(all_te), t(all_tr))
    want = getattr(jf, f"{name}_distance")(*(jnp.asarray(a) for a in (te, tr, all_te, all_tr)))
    assert got.shape == (B, 2 * B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 * scale)


def test_mp_ce_with_distance_matches_golden_and_jax(g):
    args = (g["logits"], g["pos_mask"], g["weighted_euclidean"])
    logits = t(args[0]).clone().requires_grad_()
    got = tf.multi_positive_cross_entropy_loss_with_distance(logits, t(args[1]), t(args[2]))
    got.backward()
    np.testing.assert_allclose(got.item(), g["mp_ce_dist"], rtol=RTOL)
    jargs = [jnp.asarray(a) for a in args]
    want, jgrad = jax.value_and_grad(jf.multi_positive_cross_entropy_loss_with_distance)(*jargs)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert_grads_close([logits.grad], [jgrad], "mp_ce_dist")


def test_siglip_matches_golden_and_jax(g):
    args = (g["img"], g["txt"], g["scale"], g["bias"])
    got, want, grads, jgrads = value_and_grads(tc.siglip_loss, jc.siglip_loss, args, 4)
    np.testing.assert_allclose(got["loss"].item(), g["siglip_loss"], rtol=RTOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=RTOL)
    assert set(got) == set(want) and got["contrastive_loss"] is got["loss"]
    assert_grads_close(grads, jgrads, "siglip")


def test_sigmoid_pair_loss_negative_only_matches_jax():
    x = inputs(2)
    args = (x["img"], x["txt"][:40], x["scale"], x["bias"])
    got = tf.sigmoid_pair_loss(*(t(a) for a in args), negative_only=True)
    want = jf.sigmoid_pair_loss(*(jnp.asarray(a) for a in args), negative_only=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_supcon_matches_golden_and_jax(g):
    feats = t(g["sup_feats"]).clone().requires_grad_()
    got = tf.supervised_contrastive_loss(feats, t(g["sup_labels"]))
    got.backward()
    np.testing.assert_allclose(got.item(), g["supcon"], rtol=RTOL)
    labels = jnp.asarray(g["sup_labels"])
    want, jgrad = jax.value_and_grad(
        lambda f: jf.supervised_contrastive_loss(f, labels))(jnp.asarray(g["sup_feats"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert_grads_close([feats.grad], [jgrad], "supcon")


# ---- the losses against JAX, values and gradients ---------------------------


# name -> (port fn, JAX fn, argument names); the gradients are taken with
# respect to the student's features, the logit scale and SigLIP's bias
CASES = {
    "vision_only": (tc.multipositive_clip_loss_vision_only,
                    jc.multipositive_clip_loss_vision_only, ("img", "labels", "scale")),
    "lam": (partial(tc.multipositive_clip_loss_with_vision, lam=0.3),
            partial(jc.multipositive_clip_loss_with_vision, lam=0.3),
            ("img", "txt", "labels", "scale")),
    "siglip": (tc.siglip_loss, jc.siglip_loss, ("img", "txt", "scale", "bias")),
    "distill": (tc.distill_clip_loss, jc.distill_clip_loss,
                ("img", "txt", "scale", "dimg", "dtxt", "dscale")),
    "chunked": (partial(tfl.chunked_multipositive_clip_loss, delta=0.3, chunk_size=16),
                partial(jfl.chunked_multipositive_clip_loss, delta=0.3, chunk_size=16),
                ("img", "txt", "labels", "scale")),
}
DIFFERENTIATED = ("img", "txt", "scale", "bias")


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name):
    """Every key of the JAX function's dict, and the gradients with
    respect to the features and the logit scale (SigLIP: and its bias)."""
    port_fn, jax_fn, names = CASES[name]
    x = inputs(3)
    args = [x[n] for n in names]
    diff = [i for i, n in enumerate(names) if n in DIFFERENTIATED]
    targs = [t(a).clone().requires_grad_(i in diff) for i, a in enumerate(args)]
    got = port_fn(*targs)
    got["loss"].backward()
    jargs = [jnp.asarray(a) for a in args]
    want = jax_fn(*jargs)

    def jloss(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        return jax_fn(*full)["loss"]

    jgrads = jax.grad(jloss, argnums=tuple(range(len(diff))))(*[jargs[i] for i in diff])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=RTOL, err_msg=key)
    assert_grads_close([targs[i].grad for i in diff], jgrads, name)


@pytest.mark.parametrize("scale", [1.0, 1000.0], ids=["seconds", "milliseconds"])
@pytest.mark.parametrize("distance_fn", ["weighted_euclidean", "mahalanobis"])
def test_distance_loss_and_gradients_match_jax(scale, distance_fn):
    """At TE/TR in seconds and in milliseconds."""
    x = inputs(4)
    te, tr = te_tr(np.random.RandomState(5), B, scale)
    args = (x["img"], x["txt"], x["labels"], te, tr, x["scale"])
    targs = [t(a).clone().requires_grad_(i in (0, 1, 5)) for i, a in enumerate(args)]
    got = tc.multipositive_clip_loss_with_distance(*targs, delta=0.3, distance_fn=distance_fn)
    got["loss"].backward()
    jargs = [jnp.asarray(a) for a in args]

    def jloss(img, txt, s):
        return jc.multipositive_clip_loss_with_distance(
            img, txt, jargs[2], jargs[3], jargs[4], s, delta=0.3, distance_fn=distance_fn)

    want = jloss(jargs[0], jargs[1], jargs[5])
    jgrads = jax.grad(lambda *a: jloss(*a)["loss"], argnums=(0, 1, 2))(jargs[0], jargs[1],
                                                                        jargs[5])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=RTOL, err_msg=key)
    assert_grads_close([targs[i].grad for i in (0, 1, 5)], jgrads, f"distance {scale}")


def test_distance_changes_the_loss_only_at_millisecond_scale():
    """The distance enters only the detached row max, so it cancels from
    pos_sum / all_sum except through the two 1e-12 terms: at seconds the
    weighted-Euclidean loss equals the loss with the distance left out (a
    zero distance); at milliseconds (distances up to ~3000) rows underflow
    and the loss moves far from it, on both sides alike. Mahalanobis
    distances are scale-free and stay small at both scales."""
    x = inputs(6)
    args = [t(x[n]) for n in ("img", "txt", "labels")]
    for scale, moves in ((1.0, False), (1000.0, True)):
        te, tr = te_tr(np.random.RandomState(7), B, scale)
        with_d = tc.multipositive_clip_loss_with_distance(*args, t(te), t(tr), t(x["scale"]))
        without = tc.multipositive_clip_loss_with_distance(*args, t(te) * 0, t(tr) * 0,
                                                           t(x["scale"]))
        want = jc.multipositive_clip_loss_with_distance(
            *(jnp.asarray(x[n]) for n in ("img", "txt", "labels")), jnp.asarray(te),
            jnp.asarray(tr), jnp.asarray(x["scale"]))
        np.testing.assert_allclose(with_d["loss"].item(), float(want["loss"]), rtol=RTOL)
        rel = abs(with_d["loss"].item() - without["loss"].item()) / without["loss"].item()
        assert (rel > 0.5) if moves else (rel < 1e-6), (scale, rel)


# ---- the chunked loss --------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, B])
@pytest.mark.parametrize("offset", [None, 0, 5])
def test_chunked_loss_matches_jax_and_dense(chunk, offset):
    """Against JAX's chunked loss (value and gradients) and the dense
    SupCon (with the self pairs at (i, offset + i) removed)."""
    x = inputs(8)
    q, k, s = (t(a).clone().requires_grad_() for a in (x["img"], x["txt"], x["scale"]))
    labels = t(x["labels"])
    got = tfl.chunked_multipositive_loss(q, k, labels, labels, s, chunk_size=chunk,
                                         exclude_diagonal_offset=offset)
    got.backward()
    jl = jnp.asarray(x["labels"])
    want, jgrads = jax.value_and_grad(
        lambda a, b, c: jfl.chunked_multipositive_loss(a, b, jl, jl, c, chunk_size=chunk,
                                                       exclude_diagonal_offset=offset),
        argnums=(0, 1, 2))(jnp.asarray(x["img"]), jnp.asarray(x["txt"]), jnp.asarray(x["scale"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert_grads_close([q.grad, k.grad, s.grad], jgrads, f"chunked {chunk} {offset}")
    pos = tf.pos_mask_from_labels(labels)
    if offset is not None:
        rows = torch.arange(B)
        keep = rows + offset < B
        pos[rows[keep], rows[keep] + offset] = 0.0
    dense = tf.multi_positive_cross_entropy_loss(t(x["scale"]) * t(x["img"]) @ t(x["txt"]).T, pos)
    np.testing.assert_allclose(got.item(), dense.item(), rtol=RTOL)


def test_chunked_loss_keeps_the_features_type_in_the_product():
    """bf16 features: the product is taken in bf16 and then cast to fp32,
    as JAX takes it (the dense loss promotes first). Both sides round the
    same bf16 products: 1e-3 relative (one bf16 rounding of a logit)."""
    x = inputs(9)
    labels = x["labels"]
    got = tfl.chunked_multipositive_clip_loss(t(x["img"]).bfloat16(), t(x["txt"]).bfloat16(),
                                              t(labels), t(x["scale"]), chunk_size=16)
    want = jfl.chunked_multipositive_clip_loss(
        jnp.asarray(x["img"], jnp.bfloat16), jnp.asarray(x["txt"], jnp.bfloat16),
        jnp.asarray(labels), jnp.asarray(x["scale"]), chunk_size=16)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-3)


def test_chunked_loss_refuses_keys_that_do_not_tile():
    x = torch.zeros(B, D)
    labels = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(AssertionError, match="tile"):
        tfl.chunked_multipositive_loss(x, x[:40], labels, labels[:40], torch.tensor(1.0),
                                       chunk_size=16)


def test_chunked_backward_holds_no_logits():
    """The autograd node keeps the inputs and four [Nq] statistics only, no
    [Nq, chunk] block: the backward recomputes the chunks."""
    x = inputs(10)
    q, k, s = (t(a).clone().requires_grad_() for a in (x["img"], x["txt"], x["scale"]))
    loss = tfl.chunked_multipositive_loss(q, k, t(x["labels"]), t(x["labels"]), s, chunk_size=8)
    saved = loss.grad_fn.saved_tensors
    assert max(v.numel() for v in saved) == B * D
    assert sum(v.dim() == 2 for v in saved) == 2  # queries and keys


# ---- train steps against JAX -------------------------------------------------


@pytest.fixture(scope="module")
def jax_mini():
    return jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla")


def _batch(scale=1.0):
    rng = np.random.RandomState(0)
    labels = np.array([0, 1, 2, 0, 1, 0, 2, 2], np.int32)
    te, tr = te_tr(rng, 8, scale)
    return dict(images=rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8),
                tokens=rng.randint(1, 49408, (8, 32)).astype(np.int32), labels=labels,
                echo_time=te, repetition_time=tr)


def _jax_batch(b):
    return dict({k: jnp.asarray(v) for k, v in b.items()},
                images=jax_normalize(jnp.asarray(b["images"])))


def _port_batch(b):
    return dict({k: t(v) for k, v in b.items()}, images=normalize_images(t(b["images"])))


def _run_steps(jax_step, jax_state, port_step, port_state, b):
    jb, pb = _jax_batch(b), _port_batch(b)
    jm, pm = [], []
    for i in range(STEPS):
        jax_state, m = jax_step(jax_state, jb, jax.random.key(i))
        # JAX's vision-only step reports no grad_norm
        jm.append((float(m["loss"]), float(m.get("grad_norm", np.nan))))
        port_state, m = port_step(port_state, pb, torch.Generator().manual_seed(i))
        pm.append((m["loss"].item(), m["grad_norm"].item()))
    return jm, pm, state_dict_from_flax(jax.device_get(jax_state.params)), port_state


def _check_steps(jm, pm, jp, pstate, loss_atol=0.0):
    """Loss and grad norm per step to 1e-5 relative; parameters after the
    steps to 2e-5 (a fifth of one Adam step at lr 1e-4)."""
    for (jl, jn), (pl_, pn) in zip(jm, pm):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5, atol=loss_atol)
        if not np.isnan(jn):
            np.testing.assert_allclose(pn, jn, rtol=1e-5)
    assert pstate.step == STEPS
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def _port_model(jv, **kw):
    return create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                        device="cpu", attn_impl="fusedp", **kw)


@pytest.mark.parametrize("scale", [1.0, 1000.0], ids=["seconds", "milliseconds"])
def test_distance_train_steps_match_jax(jax_mini, scale):
    """The loss is -log(pos_sum / all_sum) / |P(i)| per row, which nears 0
    as the 8 samples are learnt (0.50, 0.25, 0.15 at seconds): fp32 leaves
    it an absolute error of a few 1e-6 (measured 2.0e-6 at the third step,
    under 'xla' as under 'fusedp'), hence an absolute 5e-6 beside the 1e-5
    relative. At milliseconds every row of this batch underflows, on both
    sides alike: the loss sits at -log(1e-12) / |P(i)| with zero gradients
    (the reference's behaviour, ROADMAP "Faults")."""
    jm_, jv = jax_mini
    flags = SimpleNamespace(multipositiveloss=True, distance=True, delta=0.5,
                            model="ViT-B-32-mini", gather_with_grad=True)
    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    jstep = jax_build_train_step(jm_, jax_make_loss_apply(jax_create_loss(flags)), tx, donate=False)
    model = _port_model(jv)
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstep = build_train_step(model, make_loss_apply(create_loss(flags)), ptx)
    _check_steps(*_run_steps(jstep, jax_create_train_state(jv, tx), pstep,
                             create_train_state(model, ptx), _batch(scale)), loss_atol=5e-6)


def test_vision_only_steps_match_jax(jax_mini):
    jm_, jv = jax_mini
    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    model = _port_model(jv)
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    jm, pm, jp, pstate = _run_steps(jax_vision_only_step(jm_, tx), jax_create_train_state(jv, tx),
                                    build_vision_only_step(model, ptx),
                                    create_train_state(model, ptx), _batch())
    _check_steps(jm, pm, jp, pstate)
    # the text tower gets no gradient, so AdamW moves it by weight decay only
    assert pstate.opt_state.mu["token_embedding.weight"].abs().max() == 0


def test_distill_steps_match_jax(jax_mini):
    """A second ViT-B-32-mini (another seed) as the frozen teacher on both
    sides; the teacher's weights do not move."""
    jm_, jv = jax_mini
    tm, tv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla", rng_seed=1)
    flags = SimpleNamespace(distill=True, model="ViT-B-32-mini", gather_with_grad=True)
    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    jstep = jax_build_train_step(jm_, jax_make_loss_apply(jax_create_loss(flags)), tx,
                                 donate=False, teacher=(tm, tv))
    model, teacher = _port_model(jv), _port_model(tv)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstep = build_train_step(model, make_loss_apply(create_loss(flags)), ptx, teacher=teacher)
    _check_steps(*_run_steps(jstep, jax_create_train_state(jv, tx), pstep,
                             create_train_state(model, ptx), _batch()))
    assert all(torch.equal(before[k], v) for k, v in teacher.state_dict().items())
    assert not teacher.training


# ---- the frozen temperature --------------------------------------------------


def test_frozen_temperature_matches_jax(tmp_path):
    """ln 10 whatever init_logit_scale says, in no parameter tree, optimizer
    state or state dict; features and the export's logit_scale (10.0) as
    JAX's."""
    jm_, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, logit_scale_trainable=False,
                               init_logit_scale=np.log(1 / 0.07))
    assert "logit_scale" not in jv["params"] and "logit_scale" in jv["constants"]
    model = create_model("ViT-B-32-mini", device="cpu", logit_scale_trainable=False,
                         pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                         init_logit_scale=float(np.log(1 / 0.07)))
    assert "logit_scale" not in dict(model.named_parameters())
    assert "logit_scale" not in model.state_dict()
    b = _batch()
    out = model(_port_batch(b)["images"], t(b["tokens"]))
    want = jm_.apply(jv, _jax_batch(b)["images"], jnp.asarray(b["tokens"]))
    for key in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(out["logit_scale"].item(), 10.0, rtol=1e-6)
    exported = export_model(model)
    jmeta = jax_export_model(jm_, jv).meta
    np.testing.assert_allclose(exported.meta["logit_scale"], jmeta["logit_scale"], rtol=1e-6)
    np.testing.assert_allclose(exported.meta["logit_scale"], 10.0, rtol=1e-6)
    path = str(tmp_path / "frozen.mrclip")
    save_exported(exported, path)
    served = load_exported(path, device="cpu")
    assert "logit_scale" not in dict(served.model.named_parameters())
    tx = create_optimizer(lr=1e-4)
    state = create_train_state(model, tx)
    assert "logit_scale" not in state.params and "logit_scale" not in state.opt_state.mu


# ---- create_model's force_* and init_params ----------------------------------


@pytest.mark.parametrize("option", [dict(force_quick_gelu=True), dict(force_image_size=96),
                                    dict(force_context_length=16)])
def test_force_options_match_jax(option):
    jm_, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, **option)
    model = create_model("ViT-B-32-mini", device="cpu", **option,
                         pretrained=state_dict_from_flax(jax.device_get(jv["params"])))
    size = option.get("force_image_size", 64)
    ctx = option.get("force_context_length", 32)
    assert tuple(model.visual.image_size) == (size, size) and model.context_length == ctx
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (3, size, size, 3)).astype(np.uint8)
    tokens = rng.randint(1, 49408, (3, ctx)).astype(np.int32)
    out = model(normalize_images(t(images)), t(tokens))
    want = jm_.apply(jv, jax_normalize(jnp.asarray(images)), jnp.asarray(tokens))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_init_params_false_skips_the_random_init():
    """Nothing drawn (the projections stay at their zero construction
    values); a load then gives the seeded model's weights."""
    bare = create_model("ViT-B-32-mini", device="cpu", init_params=False)
    assert bare.visual.proj.abs().max() == 0 and bare.text_projection.abs().max() == 0
    seeded = create_model("ViT-B-32-mini", device="cpu", rng_seed=5)
    bare.load_state_dict(seeded.state_dict(), strict=True)
    assert all(torch.equal(v, seeded.state_dict()[k]) for k, v in bare.state_dict().items())


def test_force_patch_dropout_still_raises():
    with pytest.raises(NotImplementedError, match="force_patch_dropout.*item 4"):
        create_model("ViT-B-32-mini", device="cpu", force_patch_dropout=0.5)


# ---- text dropout ------------------------------------------------------------
#
# JAX draws its masks from a jax.random key and the port from a
# torch.Generator, so masks cannot match across the two: the tests hold eval
# mode against JAX's deterministic output, and the train-mode masks against
# a plain transcription that draws from the same generator.


@pytest.fixture(scope="module")
def dropout_pair():
    jm_, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, text_dropout=0.25)
    model = create_model("ViT-B-32-mini", device="cpu", text_dropout=0.25,
                         pretrained=state_dict_from_flax(jax.device_get(jv["params"])))
    return jm_, jv, model


def test_text_dropout_eval_matches_jax_deterministic(dropout_pair):
    jm_, jv, model = dropout_pair
    assert all(b.dropout == 0.25 for b in model.transformer.resblocks)
    assert all(b.dropout == 0.0 for b in model.visual.transformer.resblocks)
    tokens = _batch()["tokens"]
    model.eval()
    got = model.encode_text(t(tokens), normalize=True)
    want = jm_.apply(jv, None, jnp.asarray(tokens), deterministic=True)["text_features"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_text_dropout_train_mode_follows_the_generator(dropout_pair):
    """Same seed, same output; another seed, another; rate 0 in train mode
    is the undropped (eval) output; no generator in train mode raises."""
    _, _, model = dropout_pair
    tokens = t(_batch()["tokens"])
    model.train()
    runs = [model.encode_text(tokens, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.allclose(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        model.encode_text(tokens)
    for blk in model.transformer.resblocks:
        blk.dropout = 0.0
    try:
        undropped = model.encode_text(tokens, generator=torch.Generator().manual_seed(1))
        model.eval()
        torch.testing.assert_close(undropped, model.encode_text(tokens), rtol=0, atol=0)
    finally:
        for blk in model.transformer.resblocks:
            blk.dropout = 0.25


def test_text_dropout_masks_match_a_plain_transcription(dropout_pair):
    """The text tower in train mode against a line-by-line transcription of
    it (pre-LN blocks, each branch dropped before its LayerScale, keep
    1 - p, scale 1 / (1 - p)) drawing from a generator in the same state:
    equal features mean equal masks; about a quarter of the elements drop."""
    _, _, model = dropout_pair
    tokens = t(_batch()["tokens"])
    model.train()
    got = model.encode_text(tokens, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    dropped = []

    def drop(y):
        mask = torch.rand(y.shape, generator=gen) < 0.75
        dropped.append(1 - mask.float().mean().item())
        return torch.where(mask, y / 0.75, torch.zeros(()))

    with torch.no_grad():
        x = model.token_embedding(tokens.long()) + model.positional_embedding[:tokens.shape[1]]
        for blk in model.transformer.resblocks:
            x = x + drop(blk.attn(blk.ln_1(x), is_causal=True))
            x = x + drop(blk.mlp(blk.ln_2(x)))
        x = model.ln_final(x)
        pooled = x[torch.arange(x.shape[0]), tokens.argmax(-1)] @ model.text_projection
    torch.testing.assert_close(got, pooled, rtol=1e-6, atol=1e-6)
    assert len(dropped) == 4 and all(0.2 < d < 0.3 for d in dropped)


def test_dropout_helper():
    x = torch.ones(1000)
    assert dropout(x, 0.0, None) is x
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(0)))


def test_text_dropout_step_is_deterministic_in_the_generator():
    """A train step with text dropout: the same generator seed gives the
    same loss, another seed another."""
    b = _batch()
    losses = []
    for seed in (0, 0, 1):
        model = create_model("ViT-B-32-mini", device="cpu", text_dropout=0.1)
        tx = create_optimizer(lr=1e-4)
        step = build_train_step(model, make_loss_apply(create_loss(
            SimpleNamespace(multipositiveloss=True, delta=0.5))), tx)
        _, m = step(create_train_state(model, tx), _port_batch(b), torch.Generator().manual_seed(seed))
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("name", list(CASES) + ["distance"])
def test_losses_refuse_a_device_axis(name):
    """The gathered forms come with multi-GPU training."""
    x = {k: t(v) for k, v in inputs(12).items()}
    if name == "distance":
        fn, args = tc.multipositive_clip_loss_with_distance, [x["img"], x["txt"], x["labels"],
                                                              x["scale"], x["scale"], x["scale"]]
    else:
        fn, _, names = CASES[name]
        args = [x[n] for n in names]
    with pytest.raises(NotImplementedError, match="item 6, multi-GPU"):
        fn(*args, axis_name="data")

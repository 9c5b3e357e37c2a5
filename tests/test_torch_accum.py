"""Gradient accumulation in the port's train step (`build_train_step(...,
accum_freq=A, cached_features_accum=...)`) against the JAX package's, on
one set of weights.

ViT-B-32-mini in fp32 (the port under 'fusedp', its plain versions on the
CPU; JAX under 'xla'), 12 rows from numpy seeds with repeated labels, one
step from the same weights at A = 2 and 3 in both modes, with the dense and
the pallas loss (JAX's pallas loss in interpret mode, as off a TPU it runs
itself). The optimizer is SGD, whose first step is linear in the gradient,
so the parameters after it show the plain mode's mean apart from the
cached mode's sum. Then the JAX package's own check (cached mode equals
one unsplit step, plain mode does not), text dropout (the port's two
passes draw one set of masks; JAX's masks come from its own RNG and cannot
match, so the port is held against a plain transcription drawing from the
same generator), and a narrow MobileCLIP-S1 (the from-scratch FastViT has
no BatchNorm, in JAX as in the port, so there are no running statistics to
thread; its depthwise convolutions run in both passes).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrclip_tpu.models.fastvit as jax_fastvit
from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.models import fastvit
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)
from mrclip_tpu_torch.parallel.train_step import _grads

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N = 12
LR = 0.5  # SGD: params after one step = p - LR (1 + 0.9) g (zero trace), wd 0


def _loss_args(pallas: bool, model="ViT-B-32-mini"):
    return SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=pallas, model=model,
                           gather_with_grad=True)


def _batch(size=64, ctx=32, n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"images": rng.rand(n, size, size, 3).astype(np.float32),
            "tokens": rng.randint(1, 49408, (n, ctx)).astype(np.int32),
            "labels": rng.randint(0, 4, (n,)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class Recorder:
    """An optimizer that records the gradients and grad norm it is given
    and leaves the parameters alone."""

    def __init__(self):
        self.grads, self.grad_norm = None, None

    def init(self, params):
        return SimpleNamespace(count=0)

    def update(self, grads, state, params, grad_norm=None):
        self.grads = {k: v.clone() for k, v in grads.items()}
        self.grad_norm = grad_norm
        return state


@pytest.fixture(scope="module")
def vit():
    jm, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla")
    return jm, jax.device_get(jv["params"])


def _jax_step(jm, params, batch, accum, cached, pallas, model="ViT-B-32-mini"):
    """(loss, grad_norm, params after one SGD step) of the JAX package."""
    tx = jax_create_optimizer(lr=LR, wd=0.0, opt="sgd")
    state = jax_create_train_state({"params": params}, tx)
    step = jax_build_train_step(jm, jax_make_loss_apply(jax_create_loss(_loss_args(pallas, model))),
                                tx, accum_freq=accum, cached_features_accum=cached, donate=False)
    state, m = step(state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    return float(m["loss"]), float(m["grad_norm"]), state_dict_from_flax(jax.device_get(state.params))


def _port_step(model, batch, accum, cached, pallas, model_name="ViT-B-32-mini"):
    tx = create_optimizer(lr=LR, wd=0.0, opt="sgd")
    state = create_train_state(model, tx)
    step = build_train_step(model, make_loss_apply(create_loss(_loss_args(pallas, model_name))), tx,
                            accum_freq=accum, cached_features_accum=cached)
    state, m = step(state, _torch(batch), torch.Generator().manual_seed(0))
    return m["loss"].item(), m["grad_norm"].item(), state.params


@pytest.mark.parametrize("pallas", [False, True], ids=["dense", "pallas"])
@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
@pytest.mark.parametrize("accum", [2, 3])
def test_accumulated_step_matches_jax(vit, accum, cached, pallas):
    """Loss and grad_norm to 1e-5 relative; every parameter after the SGD
    step to 2e-5 absolute (a step moves them by up to ~0.3: 1.9 LR |g|;
    fp32 summation order differs between the two)."""
    jm, params = vit
    batch = _batch()
    jl, jn, jp = _jax_step(jm, params, batch, accum, cached, pallas)
    model = create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(params), device="cpu",
                         attn_impl="fusedp")
    pl_, pn, pp = _port_step(model, batch, accum, cached, pallas)
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    np.testing.assert_allclose(pn, jn, rtol=1e-5)
    init = state_dict_from_flax(params)
    for name, p in pp.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    assert max((jp[k] - init[k]).abs().max().item() for k in init) > 1e-3  # the step moved them


def test_cached_mode_is_the_unsplit_step_and_plain_is_not():
    """The JAX package's own property (tests/test_accum_equivalence.py):
    each cached microbatch's loss is taken over all 12 rows, so the cached
    loss equals one unsplit step's (1e-6 relative) and the summed gradients
    are that step's gradients (1e-5 relative to the largest), but for the
    temperature's: every pass's loss reaches the live `logit_scale` over
    all rows, so the sum holds A times the unsplit gradient (the JAX
    package's sum and the reference's loop do the same). Plain accumulation
    contrasts within its microbatches, a different loss, and averages, so
    its gradient is not the unsplit one."""
    model = create_model("ViT-B-32-mini", device="cpu", attn_impl="fusedp")
    apply = make_loss_apply(create_loss(_loss_args(False)))
    batch = _torch(_batch())
    results = {}
    for mode, kw in (("full", {}), ("cached", dict(accum_freq=2, cached_features_accum=True)),
                     ("plain", dict(accum_freq=2))):
        rec = Recorder()
        state = create_train_state(model, rec)
        _, m = build_train_step(model, apply, rec, **kw)(state, batch)
        results[mode] = (m["loss"].item(), rec.grads)
    (lf, gf), (lc, gc), (lp, gp) = results["full"], results["cached"], results["plain"]
    np.testing.assert_allclose(lc, lf, rtol=1e-6)
    for k in gf:
        want = gf[k] * (2 if k == "logit_scale" else 1)
        assert (gc[k] - want).abs().max().item() <= 1e-5 * (want.abs().max().item() + 1e-12), k
    assert abs(lp - lf) > 1e-3
    assert max((gp[k] - gf[k]).abs().max().item() / (gf[k].abs().max().item() + 1e-12)
               for k in gf) > 1e-2


def _dropout_model():
    text_cfg = dict(get_model_config("ViT-B-32-mini")["text_cfg"], dropout=0.3)
    return create_model("ViT-B-32-mini", device="cpu", attn_impl="fusedp", text_cfg=text_cfg)


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_text_dropout_draws_one_set_of_masks_per_microbatch(cached):
    """With text dropout 0.3, the step against a plain transcription: the
    three microbatches' forwards with gradients, one after another from the
    same generator seed (so the same masks), their features concatenated
    under the loss on all rows (cached) or each microbatch's loss on its
    own rows, averaged (plain). Loss 1e-6 relative, gradients 1e-5 of the
    largest. Had pass 2 drawn new masks, the cached loss would not be the
    loss of the pass-1 features, and the gradients would differ by the
    dropout's whole effect."""
    model = _dropout_model()
    apply = make_loss_apply(create_loss(_loss_args(False)))
    batch = _torch(_batch())
    rec = Recorder()
    state = create_train_state(model, rec)
    step = build_train_step(model, apply, rec, accum_freq=3, cached_features_accum=cached)
    _, m = step(state, batch, torch.Generator().manual_seed(7))

    gen = torch.Generator().manual_seed(7)
    model.train()
    micro = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()} for i in range(3)]
    outs = [model(mb["images"], mb["tokens"], generator=gen) for mb in micro]
    if cached:
        feats = dict(outs[0], image_features=torch.cat([o["image_features"] for o in outs]),
                     text_features=torch.cat([o["text_features"] for o in outs]))
        loss = apply(feats, batch)["loss"]
        grads = _grads(loss, state.params)
    else:
        losses = [apply(o, mb)["loss"] for o, mb in zip(outs, micro)]
        loss = sum(losses) / 3
        grads = _grads(loss, state.params)
    np.testing.assert_allclose(m["loss"].item(), loss.item(), rtol=1e-6)
    for k, g in grads.items():
        if cached and k == "logit_scale":
            g = 3 * g  # each pass's loss reaches the temperature in full
        assert (rec.grads[k] - g).abs().max().item() <= 1e-5 * (g.abs().max().item() + 1e-12), k
    # the masks matter: another seed moves the loss
    _, m2 = step(create_train_state(model, rec), batch, torch.Generator().manual_seed(8))
    assert abs(m2["loss"].item() - m["loss"].item()) > 1e-4


NARROW = ((1, 0, 0, 1), (8, 16, 32, 64), 3.0)
MCI_TEXT = dict(context_length=16, vocab_size=49408, width=64, heads=2, layers=1)


def test_mobileclip_cached_accumulation_matches_jax(monkeypatch):
    """A narrow MobileCLIP-S1 (one RepMixer block, 64 x 64 px, XLA's
    convolution on both sides) in the cached mode at A = 2, whose two
    passes both run the tower in train mode: loss, grad_norm and the SGD
    step as above."""
    cached = True
    monkeypatch.setitem(jax_fastvit.FASTVIT_DIMS, "fastvit_mci1", NARROW)
    monkeypatch.setitem(fastvit.FASTVIT_DIMS, "fastvit_mci1", NARROW)
    vision = dict(get_model_config("MobileCLIP-S1")["vision_cfg"], image_size=64)
    jm, jv = jax_create_model("MobileCLIP-S1", scan_layers=False, attn_impl="xla",
                              vision_cfg=vision, text_cfg=MCI_TEXT)
    params = jax.device_get(jv["params"])
    assert "batch_stats" not in jv  # no BatchNorm in the from-scratch FastViT
    batch = _batch(ctx=16, n=8)
    jl, jn, jp = _jax_step(jm, params, batch, 2, cached, False, model="MobileCLIP-S1")
    model = create_model("MobileCLIP-S1", pretrained=state_dict_from_flax(params), device="cpu",
                         vision_cfg=vision, text_cfg=MCI_TEXT, attn_impl="xla")
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in model.modules())
    pl_, pn, pp = _port_step(model, batch, 2, cached, False, model_name="MobileCLIP-S1")
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    np.testing.assert_allclose(pn, jn, rtol=1e-5)
    for name, p in pp.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_freeze_bn_subtrees_puts_the_statistics_back():
    """`freeze_bn_subtrees=('visual',)` (--lock-image-freeze-bn-stats) on a
    model whose visual tower holds a BatchNorm (no ported tower has one):
    its running statistics come out of the step as they went in; without
    it they move. A stand-in model: BatchNorm over the image features."""

    class Tower(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = torch.nn.BatchNorm1d(12)
            self.proj = torch.nn.Linear(12, 4)

        def forward(self, x):
            return self.proj(self.bn(x.reshape(len(x), -1)[:, :12]))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.visual = Tower()
            self.text = torch.nn.Embedding(10, 4)
            self.logit_scale = torch.nn.Parameter(torch.tensor(2.0))

        def forward(self, images, tokens, generator=None):
            img = torch.nn.functional.normalize(self.visual(images), dim=-1)
            txt = torch.nn.functional.normalize(self.text(tokens).mean(1), dim=-1)
            return {"image_features": img, "text_features": txt,
                    "logit_scale": self.logit_scale.exp()}

    batch = {"images": torch.randn(8, 2, 2, 3, generator=torch.Generator().manual_seed(0)),
             "tokens": torch.randint(0, 10, (8, 3), generator=torch.Generator().manual_seed(1)),
             "labels": torch.tensor([0, 1, 0, 1, 2, 2, 0, 1])}
    apply = make_loss_apply(create_loss(_loss_args(False)))
    for towers, stays in ((("visual",), True), ((), False)):
        model = Model()
        tx = create_optimizer(lr=1e-3)
        before = model.visual.bn.running_mean.clone()
        build_train_step(model, apply, tx, accum_freq=2, cached_features_accum=True,
                         freeze_bn_subtrees=towers)(create_train_state(model, tx), batch)
        assert torch.equal(model.visual.bn.running_mean, before) == stays

"""Per-block remat in the port (`create_model(grad_checkpointing=True,
remat_policy=...)`, `models.transformer.remat_call`) against no remat and
against the JAX package under the same policy, on one set of weights.

fp32 on the CPU, inputs from numpy seeds: ViT-B-32-mini (the port under
'fusedp', its plain versions; JAX under 'xla'), the narrow EVA02 tower of
tests/test_torch_eva02.py and a narrow MobileCLIP-S1. On the CPU the
recompute repeats the forward's arithmetic exactly, so the port's
gradients under every policy are bit-equal to its gradients without remat;
against JAX they meet tests/test_torch_train_step.py's bars. Then the
traps: text dropout from an explicit generator (its state is no part of
what `torch.utils.checkpoint` preserves), BatchNorm running statistics
under a train-mode recompute, and the attention's autograd Function, whose
forward the recompute must run again.
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
from mrclip_tpu.models.vision import VisionTransformer as JaxVisionTransformer
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.models import fastvit, transformer
from mrclip_tpu_torch.models.transformer import remat_call
from mrclip_tpu_torch.models.vision import EvaVisionTransformer
from mrclip_tpu_torch.ops import fused_attn
from mrclip_tpu_torch.parallel import make_loss_apply
from mrclip_tpu_torch.parallel.train_step import loss_and_grads

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

POLICIES = ["full", "dots", "mlp_only"]
ARGS = SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=False, gather_with_grad=True,
                       model="ViT-B-32-mini")


def _batch(size=64, ctx=32, n=8):
    rng = np.random.RandomState(0)
    return {"images": rng.rand(n, size, size, 3).astype(np.float32),
            "tokens": rng.randint(1, 49408, (n, ctx)).astype(np.int32),
            "labels": np.array([0, 1, 2, 0, 1, 0, 2, 2][:n], np.int32)}


def _port_grads(model, batch, generator=None):
    apply = make_loss_apply(create_loss(ARGS))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, ld = loss_and_grads(model, apply, dict(model.named_parameters()), tb, generator)
    return grads, ld["loss"].item()


def _jax_grads(jm, params, batch):
    apply = jax_make_loss_apply(jax_create_loss(ARGS))
    jb = jax.tree.map(jnp.asarray, batch)

    def loss(p):
        out = jm.apply({"params": p}, jb["images"], jb["tokens"], deterministic=False)
        return apply(out, jb)["loss"]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return state_dict_from_flax(jax.device_get(grads)), float(value)


def _assert_close_to_jax(got, want):
    """tests/test_torch_train_step.py's bars: rtol 1e-4, atol 5e-6."""
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=5e-6,
                                   err_msg=name)


@pytest.fixture(scope="module")
def vit():
    jm, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla")
    params = jax.device_get(jv["params"])
    model = create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(params), device="cpu",
                         attn_impl="fusedp")
    return jm, params, _port_grads(model, _batch())


@pytest.mark.parametrize("policy", POLICIES)
def test_vit_remat_matches_no_remat_and_jax(vit, policy):
    jm, params, (plain, plain_loss) = vit
    model = create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(params), device="cpu",
                         attn_impl="fusedp", grad_checkpointing=True, remat_policy=policy)
    assert model.transformer.remat == model.visual.transformer.remat == policy
    grads, loss = _port_grads(model, _batch())
    assert loss == plain_loss
    for name, g in grads.items():
        assert torch.equal(g, plain[name]), name
    want, jloss = _jax_grads(jm.clone(remat=True, remat_policy=policy), params, _batch())
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_close_to_jax(grads, want)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_text_dropout_under_remat_draws_the_forward_masks(monkeypatch, policy):
    """Text dropout 0.3 from an explicit generator: the remat'd step's
    gradients are bit-equal to the step without remat from the same seed.
    With the generator left where the forward put it (the restore taken
    out), the recompute draws new masks and the gradients are wrong."""
    text_cfg = dict(get_model_config("ViT-B-32-mini")["text_cfg"], dropout=0.3)
    models = {p: create_model("ViT-B-32-mini", device="cpu", attn_impl="fusedp",
                              text_cfg=text_cfg, grad_checkpointing=p is not None,
                              remat_policy=p or "dots") for p in (None, policy)}
    base, _ = _port_grads(models[None], _batch(), torch.Generator().manual_seed(3))
    grads, _ = _port_grads(models[policy], _batch(), torch.Generator().manual_seed(3))
    for name, g in grads.items():
        assert torch.equal(g, base[name]), name

    class Unrestored:
        def __init__(self, *a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(transformer, "_as_in_forward", Unrestored)
    wrong, _ = _port_grads(models[policy], _batch(), torch.Generator().manual_seed(3))
    worst = max((wrong[n] - base[n]).abs().max().item() for n in base)
    assert worst > 1e-3


@pytest.mark.parametrize("policy", [None, *POLICIES])
def test_recompute_runs_the_attention_function_again(monkeypatch, policy):
    """The packed attention's autograd Function (K1/K3 on the card) runs
    its forward once per layer, and once more per layer under remat, for
    every policy: the dispatcher sees the kernels' outputs only as `empty`,
    which no policy keeps, so the recompute repeats the forward and the
    backward reads the recomputed (q, k, v, o, lse). Its backward runs once
    per layer either way."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fused_attn.fused_attention_packed, fused_attn.fused_attention_packed_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(fused_attn, "fused_attention_packed", fwd)
    monkeypatch.setattr(fused_attn, "fused_attention_packed_bwd", bwd)
    model = create_model("ViT-B-32-mini", device="cpu", attn_impl="fusedp",
                         grad_checkpointing=policy is not None, remat_policy=policy or "dots")
    layers = len(model.transformer.resblocks) + len(model.visual.transformer.resblocks)
    _port_grads(model, _batch())
    assert calls == {"fwd": layers * (1 if policy is None else 2), "bwd": layers}


def _narrow_eva(remat, impl):
    """tests/test_torch_eva02.py's narrow EVA02 tower, both sides."""
    kw = dict(image_size=16, patch_size=4, width=32, layers=2, heads=2, output_dim=24,
              rope_ref_feat_shape=(8, 8))
    jax_tower = JaxVisionTransformer(
        mlp_ratio=4 * 2 / 3, patch_bias=True, no_ln_pre=True, pool_type="tok", use_rope=True,
        mlp_type="swiglu", mlp_norm=True, attn_inner_norm=True, attn_zero_k_bias=True,
        ln_eps=1e-6, attn_impl="xla", scan_layers=False, remat=remat is not None,
        remat_policy=remat or "dots", **kw)
    return jax_tower, EvaVisionTransformer(attn_impl=impl, remat=remat, **kw)


@pytest.mark.parametrize("policy", POLICIES)
def test_eva02_tower_remat_matches_no_remat_and_jax(policy):
    """The gradients of a fixed projection of the tower's features: the
    port under 'fusedp' (K2/K3r plain) remat'd vs not (bit-equal), and vs
    JAX remat'd under the same policy (rtol 1e-4, atol 5e-6)."""
    imgs = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    w = np.random.RandomState(5).randn(2, 24).astype(np.float32)
    jax_tower, tower = _narrow_eva(policy, "fusedp")
    params = jax.device_get(jax_tower.init(jax.random.PRNGKey(0), jnp.asarray(imgs))["params"])
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32),
                          params)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jax_tower.apply(
        {"params": p}, jnp.asarray(imgs), deterministic=False) * w)))(params)
    want = {k.removeprefix("visual."): v for k, v in
            state_dict_from_flax({"visual": jax.device_get(jgrads)}).items()}
    sd = {k.removeprefix("visual."): v for k, v in state_dict_from_flax({"visual": params}).items()}
    plain_tower = _narrow_eva(None, "fusedp")[1]
    got = {}
    for key, t in (("remat", tower), ("plain", plain_tower)):
        t.load_state_dict(sd, strict=True)
        loss = (t(torch.from_numpy(imgs)) * torch.from_numpy(w)).sum()
        names = [n for n, _ in t.named_parameters()]
        got[key] = dict(zip(names, torch.autograd.grad(loss, [p for _, p in t.named_parameters()])))
    for name, g in got["remat"].items():
        assert torch.equal(g, got["plain"][name]), name
    _assert_close_to_jax(got["remat"], {k: want[k] for k in got["remat"]})


NARROW = ((1, 0, 0, 1), (8, 16, 32, 64), 3.0)
MCI_TEXT = dict(context_length=16, vocab_size=49408, width=64, heads=2, layers=1)


@pytest.fixture
def narrow_mobileclip(monkeypatch):
    monkeypatch.setitem(jax_fastvit.FASTVIT_DIMS, "fastvit_mci1", NARROW)
    monkeypatch.setitem(fastvit.FASTVIT_DIMS, "fastvit_mci1", NARROW)
    return dict(get_model_config("MobileCLIP-S1")["vision_cfg"], image_size=64)


def test_mobileclip_remat_matches_no_remat_and_jax(narrow_mobileclip):
    """The narrow MobileCLIP-S1 (its RepMixer block recomputed whole, the
    attention stage under each policy): bit-equal to no remat for each
    policy, and against JAX under 'dots' (its RepMixer `nn.remat` takes no
    policy)."""
    vision = narrow_mobileclip
    jm, jv = jax_create_model("MobileCLIP-S1", scan_layers=False, attn_impl="xla",
                              vision_cfg=vision, text_cfg=MCI_TEXT, grad_checkpointing=True,
                              remat_policy="dots")
    params = jax.device_get(jv["params"])
    batch = _batch(ctx=16)
    sd = state_dict_from_flax(params)
    grads = {}
    for policy in (None, *POLICIES):
        model = create_model("MobileCLIP-S1", pretrained=sd, device="cpu", vision_cfg=vision,
                             text_cfg=MCI_TEXT, attn_impl="xla", grad_checkpointing=policy is not None,
                             remat_policy=policy or "dots")
        assert model.visual.remat == policy
        grads[policy], _ = _port_grads(model, batch)
    for policy in POLICIES:
        for name, g in grads[policy].items():
            assert torch.equal(g, grads[None][name]), (policy, name)
    want, _ = _jax_grads(jm, params, batch)
    _assert_close_to_jax(grads["dots"], want)


def test_batchnorm_statistics_move_once_under_remat():
    """A block with BatchNorm in train mode under `remat_call`: its running
    statistics after forward and backward equal those of the same block
    without remat (one update); torch's checkpoint alone would update them
    again in the recompute."""
    torch.manual_seed(0)
    x = torch.randn(16, 6)

    def block():
        torch.manual_seed(1)
        return torch.nn.Sequential(torch.nn.Linear(6, 6), torch.nn.BatchNorm1d(6),
                                   torch.nn.Linear(6, 6)).train()

    stats = {}
    for mode in ("plain", "remat", "checkpoint only"):
        b = block()
        xi = x.clone().requires_grad_()
        if mode == "plain":
            y = b(xi)
        elif mode == "remat":
            y = remat_call(b, xi)
        else:
            y = torch.utils.checkpoint.checkpoint(b, xi, use_reentrant=False)
        y.square().sum().backward()
        stats[mode] = (b[1].running_mean.clone(), int(b[1].num_batches_tracked))
    assert torch.equal(stats["remat"][0], stats["plain"][0]) and stats["remat"][1] == 1
    assert stats["checkpoint only"][1] == 2


def test_remat_policy_must_be_known():
    with pytest.raises(ValueError, match="remat policy"):
        create_model("ViT-B-32-mini", device="cpu", grad_checkpointing=True, remat_policy="some")

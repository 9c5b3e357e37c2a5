"""Export, load and the HTTP server of the PyTorch port (mrclip_tpu_torch
serving.py / serve.py / export.py) on the CPU, mirroring tests/test_serve.py.

The served model carries the JAX package's ViT-B-32-mini weights, so the
features the server returns are checked against JAX `model.apply`.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mrclip_tpu_torch import export as export_cli
from mrclip_tpu_torch import state_dict_from_flax
from mrclip_tpu_torch.factory import create_model
from mrclip_tpu_torch.serve import _Batcher, make_server
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

JAX_META_KEYS = {"image_size", "context_length", "int8", "batch_size", "tokenizer",
                 "logit_scale", "logit_bias"}


@pytest.fixture(scope="module")
def jax_model():
    return jax_create_model("ViT-B-32-mini", scan_layers=False)


@pytest.fixture(scope="module")
def artifact(jax_model, tmp_path_factory):
    _, jv = jax_model
    model = create_model(
        "ViT-B-32-mini", pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
        device="cpu", attn_impl="fusedp",
    )
    path = str(tmp_path_factory.mktemp("srv") / "m.mrclip")
    save_exported(export_model(model), path)
    return path


def _start(path, **kw):
    srv = make_server(path, host="127.0.0.1", port=0, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(artifact):
    srv, base = _start(artifact)
    yield base
    srv.shutdown()
    srv.server_close()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_health(server):
    with urllib.request.urlopen(server + "/health", timeout=60) as r:
        res = json.loads(r.read())
    assert res["ok"] is True
    meta = res["meta"]
    assert JAX_META_KEYS <= set(meta)
    assert meta["context_length"] == 32 and meta["batch_size"] is None
    assert meta["attn_impl"] == "fusedp" and meta["precision"] == "fp32"
    assert meta["model_cfg"]["embed_dim"] == 64


def test_encode_and_score_match_jax(server, jax_model):
    jm, jv = jax_model
    texts = ["a brain MRI", "a knee MRI"]
    imgs = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    txt = np.asarray(_post(server, "/encode_text", {"texts": texts})["features"])
    img = np.asarray(_post(server, "/encode_image", {"images": imgs.tolist()})["features"])
    want = jm.apply(jv, imgs, JaxTokenizer(context_length=32)(texts))
    assert txt.shape == (2, 64) and img.shape == (2, 64)
    np.testing.assert_allclose(txt, np.asarray(want["text_features"]), atol=1e-4)
    np.testing.assert_allclose(img, np.asarray(want["image_features"]), atol=1e-4)
    res = _post(server, "/score", {"images": imgs.tolist(), "texts": texts + ["c"]})
    assert np.asarray(res["logits"]).shape == (2, 3)


def test_dynamic_batching_concurrent_requests(server):
    """16 concurrent encode_text requests coalesce through the batcher and
    every client gets ITS rows back."""
    texts = [f"an MRI of subject {i}" for i in range(16)]
    singles = {
        t: np.asarray(_post(server, "/encode_text", {"texts": [t]})["features"])[0]
        for t in texts[:3]
    }
    results, errors = {}, []

    def hit(t):
        try:
            results[t] = np.asarray(_post(server, "/encode_text", {"texts": [t]})["features"])[0]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(t,)) for t in texts]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors
    assert len(results) == 16
    for t, want in singles.items():
        np.testing.assert_allclose(results[t], want, atol=1e-5)


def test_batcher_unit_coalesces_and_splits():
    calls = []

    def fn(arr):
        calls.append(len(arr))
        return arr * 2.0

    b = _Batcher(fn, max_batch=8, window_s=0.25)
    outs = {}
    ts = [threading.Thread(target=lambda i=i: outs.__setitem__(i, b(np.full((2, 3), float(i)))))
          for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    for i in range(4):
        np.testing.assert_allclose(outs[i], np.full((2, 3), float(i)) * 2.0)
    assert sum(calls) == 8
    assert len(calls) < 4

    def bad(arr):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        _Batcher(bad, max_batch=4, window_s=0.01)(np.zeros((1, 3)))


def test_batcher_survives_malformed_payload():
    b = _Batcher(lambda a: a + 1.0, max_batch=4, window_s=0.01)
    with pytest.raises(ValueError, match="batch"):
        b(np.float32(5.0))
    np.testing.assert_allclose(b(np.zeros((2, 3))), np.ones((2, 3)))


def test_error_paths(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/encode_text", {"wrong": 1})
    assert e.value.code == 400
    req = urllib.request.Request(
        server + "/encode_text", b"not json", {"Content-Type": "application/json"}
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/encode_image", {"images": [[1.0, 2.0]]})  # not [B, H, W, 3]
    assert e.value.code == 500


def test_score_applies_logit_bias(tmp_path):
    """/score = scale * img @ txt.T + logit_bias (SigLIP-style artifacts carry
    a real bias)."""
    model = create_model("ViT-B-32-mini", device="cpu", init_logit_bias=-3.0)
    path = str(tmp_path / "m.mrclip")
    save_exported(export_model(model), path)
    meta = load_exported(path, device="cpu").meta
    assert meta["logit_bias"] == -3.0
    srv, base = _start(path, max_batch=1)
    imgs = np.random.RandomState(0).rand(1, 64, 64, 3).tolist()
    try:
        img = np.asarray(_post(base, "/encode_image", {"images": imgs})["features"])
        txt = np.asarray(_post(base, "/encode_text", {"texts": ["a"]})["features"])
        res = np.asarray(_post(base, "/score", {"images": imgs, "texts": ["a"]})["logits"])
    finally:
        srv.shutdown()
        srv.server_close()
    np.testing.assert_allclose(res, meta["logit_scale"] * img @ txt.T - 3.0, rtol=1e-5)


def test_export_cli_round_trip(tmp_path):
    """The export CLI writes an artifact that loads back into the same model."""
    path = str(tmp_path / "cli.mrclip")
    assert export_cli.main([
        "--model", "ViT-B-32-mini", "--device", "cpu", "--precision", "bf16",
        "--gelu-approx", "--output", path,
    ]) == path
    served = load_exported(path, device="cpu")
    assert served.meta["attn_impl"] == "fusedp"  # the CLI default
    assert served.meta["precision"] == "bf16" and served.meta["gelu_approx"] is True
    direct = create_model("ViT-B-32-mini", precision="bf16", device="cpu",
                          attn_impl="fusedp", gelu_approx=True)
    tokens = np.zeros((2, 32), np.int64)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    with torch.no_grad():
        want = direct.encode_text(torch.from_numpy(tokens), normalize=True).float().numpy()
    np.testing.assert_array_equal(served.encode_text(tokens), want)


@pytest.mark.parametrize("impl", ["xla", "manual", "bf16", "fused", "fusedp"])
def test_export_cli_takes_the_jax_exports_attention_choices(tmp_path, impl):
    """`--attn-impl` takes the JAX export's five choices and bakes the one
    given into the artifact, which serves it."""
    path = str(tmp_path / f"{impl}.mrclip")
    export_cli.main(["--model", "ViT-B-32-mini", "--device", "cpu", "--attn-impl", impl,
                     "--output", path])
    served = load_exported(path, device="cpu")
    assert served.meta["attn_impl"] == impl
    assert served.model.visual.transformer.resblocks[0].attn.attn_impl == impl
    tokens = np.zeros((1, 32), np.int64)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    assert np.isfinite(served.encode_text(tokens)).all()


def test_export_cli_refuses_flash(tmp_path):
    """The JAX export has no 'flash' choice, so neither has the port's."""
    with pytest.raises(SystemExit):
        export_cli.main(["--model", "ViT-B-32-mini", "--device", "cpu", "--attn-impl", "flash",
                         "--output", str(tmp_path / "f.mrclip")])

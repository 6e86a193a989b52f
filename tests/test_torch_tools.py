"""The port's checkpoint tools against the JAX package's, on the CPU.

``demfi_torch.tools.import_pt`` must write the msgpack bytes and the json
text that ``demfi_tpu.tools.import_pt`` writes for the same ``.pt`` (a
reference-style combined checkpoint, a bare state dict, and a port
training checkpoint with Adam's state), and ``export_pt`` a ``.pt`` with
the keys (in order), the tensors (bitwise) and the metadata of JAX's.
The port's codec is stdlib only; here it is held against
``flax.serialization`` byte for byte.
"""
import json

import numpy as np
import pytest
import torch

import flax.serialization

from demfi_tpu import tools as jax_tools
from demfi_torch import tools
from demfi_torch.checkpoint import (flax_params_to_state_dict, msgpack,
                                    save_checkpoint,
                                    state_dict_to_flax_params)
from demfi_torch.config import config_rb
from demfi_torch.models import make_model


@pytest.fixture(scope="module")
def weights():
    """A state dict of DeMFI-Net_rb(1,1) at nf 16 (every layer kind of
    the full model, Conv3d included), seeded."""
    model = make_model(config_rb(1, 1, nf=16, seed=4), device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _checkpoints(tmp, weights):
    """{kind: path} of the three layouts import_pt takes."""
    paths = {"combined": tmp / "DeMFInet_exp1_latest.pt",
             "bare": tmp / "bare.pt", "training": tmp / "train_latest.pt"}
    torch.save({"state_dict_Model": weights, "last_epoch": 7499,
                "best_PSNR": np.float64(33.25), "lr": 1.25e-5,
                "testPSNR": [30.5, 31.0]}, paths["combined"])
    torch.save(weights, paths["bare"])
    model = make_model(config_rb(1, 1, nf=16, seed=4), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    save_checkpoint(str(paths["training"]), model.state_dict(),
                    dict(last_epoch=3, best_PSNR=12.5, trainLoss=0.25,
                         batch_size=2), opt.state_dict())
    return paths


@pytest.mark.parametrize("kind", ["combined", "bare", "training"])
def test_import_pt_bytes_equal_jax(tmp_path, weights, kind, capsys):
    src = _checkpoints(tmp_path, weights)[kind]
    base = tools.import_pt(str(src), str(tmp_path / "port"))
    jbase = jax_tools.import_pt(str(src), str(tmp_path / "jax"))
    for ext in (".msgpack", ".json"):
        with open(base + ext, "rb") as a, open(jbase + ext, "rb") as b:
            assert a.read() == b.read(), ext
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace("/port/", "/jax/") == printed[1]
    meta = json.loads(open(base + ".json").read())
    assert not any(k.startswith("state_dict") for k in meta)
    if kind == "training":
        assert meta["last_epoch"] == 3


@pytest.mark.parametrize("kind", ["combined", "training"])
def test_export_pt_equals_jax(tmp_path, weights, kind):
    src = _checkpoints(tmp_path, weights)[kind]
    jbase = jax_tools.import_pt(str(src), str(tmp_path / "jax"))
    tools.export_pt(jbase + ".msgpack", str(tmp_path / "port.pt"))
    jax_tools.export_pt(jbase + ".msgpack", str(tmp_path / "jax.pt"))
    a = torch.load(tmp_path / "port.pt", weights_only=False)
    b = torch.load(tmp_path / "jax.pt", weights_only=False)
    assert list(a) == list(b)
    assert {k: v for k, v in a.items() if k != "state_dict_Model"} == {
        k: v for k, v in b.items() if k != "state_dict_Model"}
    sa, sb = a["state_dict_Model"], b["state_dict_Model"]
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    # and the round trip gives the weights back, loadable strictly
    for k, v in torch.load(src, weights_only=False).get(
            "state_dict_Model", weights).items():
        assert torch.equal(sa[k], v), k
    make_model(config_rb(1, 1, nf=16), device="cpu").load_state_dict(
        sa, strict=True)


def test_state_dict_to_flax_params_inverts(weights):
    from demfi_tpu.checkpoint import convert_torch_state_dict
    tree = state_dict_to_flax_params(weights)
    assert msgpack.packb(tree) == flax.serialization.to_bytes(
        convert_torch_state_dict(weights))
    back = flax_params_to_state_dict(tree)
    assert list(back) == list(weights)
    assert all(torch.equal(back[k], weights[k]) for k in weights)


def test_codec_round_trips_flax_bytes():
    """flax's bytes of a nested tree with 0-d, empty, integer, boolean,
    float64 and scalar leaves decode to flax's tree and encode back to
    the same bytes."""
    rng = np.random.RandomState(0)
    tree = {"params": {
        "zero_d": np.float32(2.5) * np.ones((), np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "ints": np.arange(-150, 150, dtype=np.int64).reshape(3, 100),
        "bools": np.array([[True, False, True]]),
        "f64": rng.randn(7, 5),
        "u8": np.arange(16, dtype=np.uint8),   # a fixext payload length
        "inner": {"w": rng.randn(3, 3, 4, 8).astype(np.float32),
                  "scalar": np.int32(-7), "f": np.float64(0.125)}},
        "step": 70000, "neg": -2 ** 33, "lr": 1e-4, "name": "x" * 40,
        "none": None, "flag": True, "blob": b"\x00" * 300}
    data = flax.serialization.to_bytes(tree)
    got = msgpack.unpackb(data)
    want = flax.serialization.msgpack_restore(data)

    def same(a, b):
        if isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        else:
            assert type(a) is type(b), (a, b)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b
    same(got, want)
    assert msgpack.packb(got) == data
    assert msgpack.packb(tree) == data


def test_codec_refuses_the_chunked_form(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    data = flax.serialization.to_bytes({"w": np.zeros(100, np.float32)})
    assert b"__msgpack_chunked_array__" in data
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(data)


def test_cli_usage_exits_2(capsys):
    for argv in ([], ["import_pt", "a.pt"], ["convert", "a", "b"]):
        with pytest.raises(SystemExit) as e:
            tools.main(argv)
        assert e.value.code == 2
        out = capsys.readouterr().out
        assert "python -m demfi_torch.tools import_pt" in out
        assert "export_pt" in out

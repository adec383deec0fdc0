"""The port's deployment layer on the CPU: the torch.export round trip of
patchify and the update operator against the eager modules, a tracker on
an export directory against the eager tracker (the analog of
tests/test_deploy.py), the directories it refuses, a fresh process that
loads update.pt2, and the import of the reference's ONNX encoders against
the JAX package's. The export is made by the export_network entry point."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.deploy.export import UpdateStep, load_exported, read_meta, update_inputs
from dpvo_tpu_torch.runtime.dpvo import DPVO
from dpvo_tpu_torch.runtime.steps import PAIR_MAX, PatchifyStep
from dpvo_tpu_torch.runtime.weights import load_networks, params_from_jax, params_to_jax
from test_torch_package import ROOT, one_torch_thread  # noqa: F401 (autouse fixture)

WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "tiny_synth.npz")
HT, WD = 48, 64
CFG = Config(**chip_smoke.SMALL_CFG)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny configuration's network exported on the CPU by the
    export_network entry point, and the eager network."""
    from dpvo_tpu_torch.apps import export_network

    tiny = [str(x) for kv in chip_smoke.SMALL_CFG.items() for x in kv]
    out = export_network.main(["--outdir", str(tmp_path_factory.mktemp("exported")), "--ht",
                               str(HT), "--wd", str(WD), "--device", "cpu", "--network", WEIGHTS,
                               "--config", "none", "--opts", *tiny])
    return out, load_networks(CFG, WEIGHTS).eval()


def test_export_network_main(exported):
    """The entry point's directory (the fixture) records the CPU, the image
    size and the configuration's E_MAX."""
    out, _ = exported
    meta = read_meta(out)
    assert meta["device"] == "cpu" and (meta["ht"], meta["wd"], meta["e_max"]) == (HT, WD, 1024)


def test_export_round_trip(exported):
    """patchify.pt2 and update.pt2 reloaded give the eager modules' outputs
    bit for bit, the update at the traced edge count and at others; the
    update program keeps the segment-sum op as nodes."""
    out, nets = exported
    assert sorted(os.listdir(out)) == ["meta.json", "params.npz", "patchify.pt2", "update.pt2"]
    net = load_exported(out)
    assert net.meta["device"] == "cpu" and net.meta["e_max"] == CFG.E_MAX
    assert any("dpvo_tpu_torch.segment_sum" in str(n.target)
               for n in net.update_program.graph.nodes)
    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (HT, WD, 3), generator=g, dtype=torch.uint8)
    centroids = torch.stack([torch.randint(1, WD // 4 - 1, (8,), generator=g),
                             torch.randint(1, HT // 4 - 1, (8,), generator=g)], -1).float()
    eager_pf = PatchifyStep(nets.patchifier, torch.float32)
    eager_up = UpdateStep(nets.update, CFG.M_OPT_MAX, 2 * PAIR_MAX)
    with torch.no_grad():
        for a, b in zip(net.patchify(image, centroids), eager_pf(image, centroids)):
            assert torch.equal(a, b)
        for E in (8, 2 * 8 + 3, 200, CFG.E_MAX):
            x = update_inputs(CFG, E, "cpu", g)
            for a, b in zip(net.update(*x), eager_up(*x)):
                assert a.shape[0] == E and torch.equal(a, b)
        with pytest.raises(ValueError, match="edges"):
            net.update(*update_inputs(CFG, CFG.E_MAX + 1, "cpu", g))
        with pytest.raises(ValueError, match="M_OPT_MAX"):
            net.update(*update_inputs(CFG, 20, "cpu", g), num_segments=CFG.M_OPT_MAX + 1)


def test_dpvo_consumes_export_dir(exported):
    """DPVO on an export directory runs its programs and tracks as the eager
    tracker does on the tiny scene with chip_smoke's small-path draws: the
    same keyframes, poses and point cloud, bit for bit on the CPU."""
    out, _ = exported
    tracker, frames, K = chip_smoke.small_path()
    frames = frames[:16]
    a = tracker("cpu")
    b = DPVO(CFG, out, HT, WD, device="cpu", draws=a.draws)
    assert b.steps.exported is not None and a.steps.exported is None
    ra, rb = chip_smoke.free_run(a, frames, K), chip_smoke.free_run(b, frames, K)
    assert ra[0] is not None and ra[0][0] == rb[0][0] and ra[1] == rb[1]
    np.testing.assert_array_equal(ra[2], rb[2])
    for x, y in zip(a.point_cloud(), b.point_cloud()):
        np.testing.assert_array_equal(x, y)


def test_dpvo_rejects_mismatched_export(exported, tmp_path):
    out, _ = exported
    with pytest.raises(ValueError, match="incompatible"):
        DPVO(CFG, out, 32, 64, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        DPVO(CFG.replace(MIXED_PRECISION=True), out, HT, WD, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        DPVO(CFG.replace(E_MAX=512), out, HT, WD, device="cpu")
    shlo = tmp_path / "jax_export"
    shlo.mkdir()
    (shlo / "patchify.shlo").write_bytes(b"")
    with pytest.raises(ValueError, match="StableHLO"):
        DPVO(CFG, str(shlo), HT, WD, device="cpu")
    with pytest.raises(ValueError, match="patchify.pt2"):
        DPVO(CFG, str(tmp_path), HT, WD, device="cpu")


_FRESH = """
import sys, torch
torch.set_num_threads(1)  # the summation order of this process's matmuls
from dpvo_tpu_torch.deploy.export import load_exported
net = load_exported(sys.argv[1])
x = torch.load(sys.argv[2])
with torch.no_grad():
    out = net.update(*x)
torch.save(out, sys.argv[3])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "dpvo_tpu"))
print(bad)
"""


def test_fresh_process_runs_update_pt2(exported, tmp_path):
    """A process that imports only the port loads update.pt2 (the segment-sum
    op registered by that import) and computes what this one does."""
    out, nets = exported
    x = update_inputs(CFG, 57, "cpu", torch.Generator().manual_seed(5))
    torch.save(x, tmp_path / "x.pt")
    run = subprocess.run([sys.executable, "-c", _FRESH, out, str(tmp_path / "x.pt"),
                          str(tmp_path / "y.pt")], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]"
    with torch.no_grad():
        want = UpdateStep(nets.update, CFG.M_OPT_MAX, 2 * PAIR_MAX)(*x)
    for a, b in zip(torch.load(tmp_path / "y.pt"), want):
        assert torch.equal(a, b)


# ---- the ONNX encoder import ----

def _varint(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, value):
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def write_onnx(path, tensors):
    """A minimal ONNX ModelProto: ir_version, a producer name, and a graph
    with one node and the tensors as float initializers (dims, data_type,
    name, raw_data), as the reference's exported files hold them."""
    inits = b"".join(
        _field(5, b"".join(_field(1, d) for d in a.shape) + _field(2, 1) +
               _field(8, name.encode()) + _field(9, np.ascontiguousarray(a, "<f4").tobytes()))
        for name, a in tensors.items())
    node = _field(1, _field(1, b"input") + _field(4, b"Conv"))
    with open(path, "wb") as f:
        f.write(_field(1, 7) + _field(2, b"pytorch") + _field(7, node + inits))


def reference_tensors(cfg, rng, net):
    """Random tensors under the reference's state-dict names for encoder
    net of cfg's widths."""
    out_dim = cfg.FDIM if net == "fnet" else cfg.DIM
    shapes = {"conv1": (32, 3, 7, 7), "conv2": (out_dim, 64, 1, 1)}
    for blk, cin, cout in (("layer1.0", 32, 32), ("layer1.1", 32, 32), ("layer2.0", 32, 64),
                           ("layer2.1", 64, 64)):
        shapes[f"{blk}.conv1"] = (cout, cin, 3, 3)
        shapes[f"{blk}.conv2"] = (cout, cout, 3, 3)
        if cin != cout:
            shapes[f"{blk}.downsample.0"] = (cout, cin, 1, 1)
    tensors = {}
    for name, s in shapes.items():
        tensors[f"{net}.{name}.weight"] = rng.normal(0, 0.1, s).astype(np.float32)
        tensors[f"{net}.{name}.bias"] = rng.normal(0, 0.1, s[:1]).astype(np.float32)
    return tensors


@pytest.fixture(scope="module")
def onnx_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    rng = np.random.default_rng(0)
    cfg = Config(DIM=32, FDIM=16)
    for net in ("fnet", "inet"):
        write_onnx(d / f"{net}.onnx", reference_tensors(cfg, rng, net))
    return d, cfg


def _tree(flat):
    tree = {}
    for key, arr in flat.items():
        *parents, leaf = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = np.asarray(v)
    return out


def test_onnx_import_matches_jax(onnx_dir):
    """parse_onnx_weights equals the JAX reader; the imported encoders equal
    JAX port_reference_encoders' carried across by runtime/weights, and
    their features agree with the JAX encoders' in f32."""
    import jax.numpy as jnp

    from dpvo_tpu.models.extractor import BasicEncoder4 as JEncoder
    from dpvo_tpu.runtime import torch_port as j_port
    from dpvo_tpu_torch.runtime import torch_port as t_port

    d, cfg = onnx_dir
    for net in ("fnet", "inet"):
        got, want = (m.parse_onnx_weights(str(d / f"{net}.onnx")) for m in (t_port, j_port))
        assert sorted(got) == sorted(want) and len(got) == 22
        for k in got:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
    nets = load_networks(cfg, None, seed=3)
    jparams = j_port.port_reference_encoders(_tree(params_to_jax(nets.state_dict())),
                                             str(d / "fnet.onnx"), str(d / "inet.onnx"))
    t_port.port_reference_encoders(nets, str(d / "fnet.onnx"), str(d / "inet.onnx"))
    want = params_from_jax(_flat(jparams))
    state = nets.state_dict()
    assert sorted(want) == sorted(state)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert torch.equal(nets.patchifier.fnet.Conv_0.weight,
                       torch.as_tensor(t_port.parse_onnx_weights(str(d / "fnet.onnx"))
                                       ["fnet.conv1.weight"]))
    img = np.random.default_rng(1).uniform(-0.5, 1.5, (1, 32, 48, 3)).astype(np.float32)
    for net, norm, dim in (("fnet", "instance", cfg.FDIM), ("inet", "none", cfg.DIM)):
        ref = JEncoder(output_dim=dim, norm_fn=norm).apply(
            {"params": jparams["patchifier"]["params"][net]}, jnp.asarray(img))
        with torch.no_grad():
            out = getattr(nets.patchifier, net)(torch.as_tensor(img))
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_onnx_import_refuses_leftovers_and_shapes(onnx_dir, tmp_path):
    from dpvo_tpu_torch.runtime import torch_port as t_port

    d, cfg = onnx_dir
    tensors = t_port.parse_onnx_weights(str(d / "fnet.onnx"))
    write_onnx(tmp_path / "extra.onnx", dict(tensors, **{"fnet.conv3.weight": np.zeros(3)}))
    with pytest.raises(ValueError, match="unmapped"):
        t_port.port_reference_encoders(load_networks(cfg), str(tmp_path / "extra.onnx"),
                                       str(d / "inet.onnx"))
    with pytest.raises(ValueError, match="shape"):
        t_port.port_reference_encoders(load_networks(cfg.replace(FDIM=8)), str(d / "fnet.onnx"),
                                       str(d / "inet.onnx"))
    del tensors["fnet.layer1.1.conv2.bias"]
    write_onnx(tmp_path / "short.onnx", tensors)
    with pytest.raises(KeyError):
        t_port.port_reference_encoders(load_networks(cfg), str(tmp_path / "short.onnx"),
                                       str(d / "inet.onnx"))


def test_train_init_encoders(onnx_dir, tmp_path, capsys, monkeypatch):
    """python -m dpvo_tpu_torch.apps.train --init_encoders DIR on the CPU:
    the encoders start from the ONNX weights (one synthetic step of AdamW
    at lr 8e-5 moves a weight by less than 1e-3)."""
    from dpvo_tpu_torch.apps import train
    from dpvo_tpu_torch.runtime import torch_port as t_port

    d, _ = onnx_dir
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL logging only
    nets, _ = train.main(["--init_encoders", str(d), "--dataset", "synthetic", "--device", "cpu",
                          "--steps", "1", "--n_frames", "4", "--unroll", "4", "--ht", "64", "--wd", "64",
                          "--outdir", str(tmp_path),
                          "--opts", "PATCHES_PER_FRAME", "4", "DIM", "32", "FDIM", "16"])
    assert f"encoders initialized from {d}" in capsys.readouterr().out
    ref = t_port.parse_onnx_weights(str(d / "inet.onnx"))
    got = nets.patchifier.inet.ResidualBlock_2.Conv_2.weight.detach().numpy()
    assert np.abs(got - ref["inet.layer2.0.downsample.0.weight"]).max() < 1e-3

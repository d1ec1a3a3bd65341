"""The port's ONNX reader (spittle_tpu_torch/io/onnx_proto.py) and Silero's
.onnx loader against the JAX package's, on an ONNX file this test writes
itself with its own protobuf writer (no onnx package; the real
silero_vad_v4.onnx is not in the repo).

The file has the reference graph's structure: a top-level If whose
then_branch (16 kHz) and else_branch (8 kHz) subgraphs carry the
model.* / model_8k.* initializers and the fourteen numbered ones, the LSTM
weights inside an If nested in each branch, from the bundled
silero_vad_v4.npz (the 8 kHz branch's values scaled so the branches
differ). Beside them: a tensor of every dtype the reader knows, in raw_data
and in the typed fields, and a node with an attribute of every kind.
"""

import struct

import numpy as np
import pytest
import torch

from spittle_tpu.audio.vad import silero as jsil
from spittle_tpu.io import onnx_proto as jonnx
from spittle_tpu_torch.audio.vad import silero as tsil
from spittle_tpu_torch.io import onnx_proto as tonnx

# ONNX TensorProto.DataType tags of the numpy dtypes.
TAGS = {np.float32: 1, np.uint8: 2, np.int8: 3, np.uint16: 4, np.int16: 5,
        np.int32: 6, np.int64: 7, np.bool_: 9, np.float16: 10, np.float64: 11,
        np.uint32: 12, np.uint64: 13}
ANON = {"16k": ("1110", "1111", "1113", "1114", "1116", "1117", "1119", "1120",
                "343", "345", "347", "415", "417", "419"),
        "8k": ("1122", "1123", "1125", "1126", "1128", "1129", "1131", "1132",
               "833", "835", "837", "905", "907", "909")}


# -- a protobuf writer -------------------------------------------------------


def varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negative ints as their two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def key(field: int, wire: int) -> bytes:
    return varint(field << 3 | wire)


def vfield(field: int, v: int) -> bytes:
    return key(field, 0) + varint(v)


def lfield(field: int, payload) -> bytes:
    if isinstance(payload, str):
        payload = payload.encode()
    return key(field, 2) + varint(len(payload)) + payload


def f32field(field: int, v: float) -> bytes:
    return key(field, 5) + struct.pack("<f", v)


def tensor(name: str, a: np.ndarray, form: str = "raw") -> bytes:
    """TensorProto: dims one field each, data_type, then raw_data, or
    float_data packed ("floats") or one fixed32 per field ("float_each"),
    int64_data packed ("int64s") or one varint per field ("int64_each"),
    int32_data packed ("int32s") or one varint per field ("int32_each")."""
    out = b"".join(vfield(1, d) for d in a.shape)
    out += vfield(2, TAGS[a.dtype.type])
    flat = a.reshape(-1)
    if form == "raw":
        out += lfield(9, a.tobytes())
    elif form == "floats":
        out += lfield(4, struct.pack(f"<{flat.size}f", *flat))
    elif form == "float_each":
        out += b"".join(f32field(4, float(x)) for x in flat)
    elif form == "int64s":
        out += lfield(7, b"".join(varint(int(x)) for x in flat))
    elif form == "int64_each":
        out += b"".join(vfield(7, int(x)) for x in flat)
    elif form == "int32s":
        out += lfield(5, b"".join(varint(int(x)) for x in flat))
    elif form == "int32_each":
        out += b"".join(vfield(5, int(x)) for x in flat)
    return out + lfield(8, name)


def attribute(name: str, **kind) -> bytes:
    """AttributeProto with one kind: f, i, s, t (array), g (graph bytes),
    floats or ints."""
    out = lfield(1, name)
    for k, v in kind.items():
        if k == "f":
            out += f32field(2, v) + vfield(20, 1)
        elif k == "i":
            out += vfield(3, v) + vfield(20, 2)
        elif k == "s":
            out += lfield(4, v) + vfield(20, 3)
        elif k == "t":
            out += lfield(5, tensor("", v)) + vfield(20, 4)
        elif k == "g":
            out += lfield(6, v) + vfield(20, 5)
        elif k == "floats":
            out += b"".join(f32field(7, x) for x in v) + vfield(20, 6)
        elif k == "ints":
            out += b"".join(vfield(8, x) for x in v) + vfield(20, 7)
    return out


def node(op: str, inputs, outputs, name="", attrs=()) -> bytes:
    out = b"".join(lfield(1, i) for i in inputs)
    out += b"".join(lfield(2, o) for o in outputs)
    out += lfield(3, name) + lfield(4, op)
    return out + b"".join(lfield(5, a) for a in attrs)


def graph(name: str, nodes=(), inits=(), inputs=(), outputs=()) -> bytes:
    out = b"".join(lfield(1, n) for n in nodes) + lfield(2, name)
    out += b"".join(lfield(5, t) for t in inits)
    out += b"".join(lfield(11, lfield(1, i)) for i in inputs)
    return out + b"".join(lfield(12, lfield(1, o)) for o in outputs)


# -- the Silero-shaped model --------------------------------------------------


def _named(tree, prefix: str, anon):
    """The npz tree's leaves under the .onnx graph's names."""
    names = {
        "stft_basis": "feature_extractor.forward_basis_buffer",
        "norm_filter": "adaptive_normalization.filter_",
        "head_w": "decoder.decoder.1.weight",
        "head_b": "decoder.decoder.1.bias",
    }
    out = {prefix + v: tree[k] for k, v in names.items()}
    conv = {"dw_w": "dw_conv.0.weight", "dw_b": "dw_conv.0.bias",
            "pw_w": "pw_conv.0.weight", "pw_b": "pw_conv.0.bias",
            "proj_w": "proj.weight", "proj_b": "proj.bias"}
    for k, v in tree["first"].items():
        out[f"{prefix}first_layer.0.{conv[k]}"] = v
    for enc, blk in zip(("3", "7", "11"), tree["blocks"]):
        for k, v in blk.items():
            out[f"{prefix}encoder.{enc}.0.{conv[k]}"] = v
    between = [x for b in tree["between"] for x in (b["w"], b["b"])]
    lstm = [x[None] for lp in tree["lstm"] for x in (lp["w"], lp["r"], lp["b"])]
    out.update(zip(anon[:8], between))
    return out, dict(zip(anon[8:], lstm))


def _branch(tree, branch: str, forms) -> bytes:
    prefix = "model." if branch == "16k" else "model_8k."
    plain, lstm = _named(tree, prefix, ANON[branch])
    # The LSTM weights live in an If nested in the branch (the reference
    # graph's zero-state / carried-state split; equal in both).
    state = graph(f"{branch}_state", inits=[tensor(k, v, next(forms))
                                            for k, v in lstm.items()])
    nested = node("If", ["has_state"], ["lstm_out"], name=f"{branch}_if",
                  attrs=[attribute("then_branch", g=state),
                         attribute("else_branch", g=state)])
    body = [node("Conv", ["input", prefix + "first_layer.0.dw_conv.0.weight"],
                 ["h"], name=f"{branch}_conv"), nested]
    return graph(f"{branch}_graph", nodes=body,
                 inits=[tensor(k, v, next(forms)) for k, v in plain.items()],
                 outputs=["lstm_out"])


def _every_dtype():
    rng = np.random.default_rng(3)
    out = []
    for dt in TAGS:
        a = rng.integers(0, 2 if dt is np.bool_ else 100, size=(2, 3)).astype(dt)
        if np.dtype(dt).kind == "i":
            a = a - 50  # negative values through the signed types
        out.append((f"dtype_{np.dtype(dt).name}", a, "raw"))
    out += [("typed_floats", rng.standard_normal(5).astype(np.float32), "floats"),
            ("typed_float_each", rng.standard_normal(3).astype(np.float32),
             "float_each"),
            ("typed_int64s", np.array([-3, 0, 7, -(1 << 40)], np.int64), "int64s"),
            ("typed_int64_each", np.array([5, -1], np.int64), "int64_each"),
            ("typed_int32s", np.array([1, 2, 300], np.int32), "int32s"),
            ("typed_int32_each", np.array([4, 99], np.int32), "int32_each"),
            ("scalar", np.array(2.5, np.float32), "raw"),
            ("empty", np.zeros((0,), np.float32), "raw")]
    return out


@pytest.fixture(scope="module")
def onnx_path(tmp_path_factory):
    tree = tsil._params_from_npz(tsil.BUNDLED_NPZ)
    scaled = _map(tree, lambda a: (a * np.float32(0.5)).astype(np.float32))
    # Tensor encodings in turn, so that float weights come through raw_data,
    # packed float_data and one fixed32 per element alike.
    cycle = ("raw", "floats", "raw", "float_each")
    forms = (cycle[i % len(cycle)] for i in range(10 ** 6))
    then_g = _branch(tree, "16k", forms)
    else_g = _branch(scaled, "8k", forms)
    attrs = [attribute("then_branch", g=then_g), attribute("else_branch", g=else_g)]
    extra = node("Misc", ["x"], ["y", "z"], name="misc", attrs=[
        attribute("alpha", f=0.25), attribute("axis", i=-3),
        attribute("mode", s=b"reflect"),
        attribute("value", t=np.arange(6, dtype=np.int64).reshape(2, 3)),
        attribute("scales", floats=[1.5, -2.0]), attribute("pads", ints=[-1, 0, 7])])
    top = graph("silero", nodes=[node("If", ["sr_is_16k"], ["out"], name="sr_if",
                                      attrs=attrs), extra],
                inits=[tensor(n, a, f) for n, a, f in _every_dtype()],
                inputs=["input", "sr", "h", "c"], outputs=["out", "hn", "cn"])
    model = vfield(1, 8) + lfield(2, "test") + lfield(7, top)
    path = tmp_path_factory.mktemp("onnx") / "silero_vad_v4.onnx"
    path.write_bytes(model)
    return str(path)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(np.asarray(tree))


def _same_graph(a, b):
    assert (a.name, a.inputs, a.outputs) == (b.name, b.inputs, b.outputs)
    assert list(a.initializers) == list(b.initializers)
    for name, x in a.initializers.items():
        y = b.initializers[name]
        assert (x.dtype, x.shape) == (y.dtype, y.shape), name
        assert x.tobytes() == y.tobytes(), name
    assert len(a.nodes) == len(b.nodes)
    for n, m in zip(a.nodes, b.nodes):
        assert (n.op_type, n.inputs, n.outputs, n.name) == (
            m.op_type, m.inputs, m.outputs, m.name)
        assert list(n.attrs) == list(m.attrs)
        for k, at in n.attrs.items():
            bt = m.attrs[k]
            assert (at.name, at.f, at.i, at.s, at.floats, at.ints) == (
                bt.name, bt.f, bt.i, bt.s, bt.floats, bt.ints)
            if at.t is not None:
                assert at.t.dtype == bt.t.dtype
                np.testing.assert_array_equal(at.t, bt.t)
            assert (at.g is None) == (bt.g is None)
            if at.g is not None:
                _same_graph(at.g, bt.g)


def test_load_onnx_matches_reference(onnx_path):
    ours, ref = tonnx.load_onnx(onnx_path), jonnx.load_onnx(onnx_path)
    _same_graph(ours, ref)
    # Every dtype and encoding came through with its values.
    for name, a, _ in _every_dtype():
        got = ours.initializers[name]
        assert got.dtype == a.dtype and got.shape == a.shape, name
        np.testing.assert_array_equal(got, a)
    misc = ours.nodes[1]
    assert misc.attr("axis") == -3 and misc.attr("pads") == [-1, 0, 7]
    assert misc.attr("alpha") == 0.25 and misc.attr("mode") == b"reflect"
    assert misc.attr("scales") == [1.5, -2.0]
    assert misc.attr("missing", "dflt") == "dflt"
    branch = ours.nodes[0].attr("then_branch")
    assert isinstance(branch, tonnx.Graph) and branch.nodes[1].op_type == "If"


@pytest.mark.parametrize("branch", ["16k", "8k"])
def test_params_from_onnx_matches_reference(onnx_path, branch):
    ours = tsil._params_from_onnx(onnx_path, branch)
    ref = _map(jsil._params_from_onnx(onnx_path, branch), np.asarray)
    flat_ours, flat_ref = jsil._flatten_tree(ours), jsil._flatten_tree(ref)
    assert sorted(flat_ours) == sorted(flat_ref)  # jax.tree.map sorts keys
    for k in flat_ref:
        assert flat_ours[k].dtype == flat_ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(flat_ours[k], flat_ref[k], err_msg=k)
    # The 16 kHz branch is the bundled weights themselves; the 8 kHz one
    # this file's halves of them.
    npz = jsil._flatten_tree(tsil._params_from_npz(tsil.BUNDLED_NPZ))
    scale = np.float32(1.0 if branch == "16k" else 0.5)
    assert sorted(flat_ours) == sorted(npz)
    for k, v in npz.items():
        np.testing.assert_array_equal(flat_ours[k], (v * scale).astype(np.float32))


def test_onnx_load_matches_npz_through_silero(onnx_path):
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, 16 * tsil.FRAME_SAMPLES_16K))
             ).astype(np.float32)
    probs = []
    for path in (onnx_path, tsil.BUNDLED_NPZ):
        params = tsil.load_silero_params(path, branch="16k", device="cpu")
        probs.append(tsil.silero_scan_frames(params, audio,
                                             tsil.init_state(2, "cpu")))
    torch.testing.assert_close(probs[0], probs[1], rtol=0, atol=0)
    vad = tsil.SileroVad(onnx_path, device="cpu")
    assert torch.equal(vad.params["stft_basis"],
                       tsil.load_silero_params(device="cpu")["stft_basis"])
    eight = tsil.load_silero_params(onnx_path, branch="8k", device="cpu")
    torch.testing.assert_close(
        eight["head_w"], tsil.load_silero_params(device="cpu")["head_w"] * 0.5,
        rtol=0, atol=0)

"""The port's ONNX interpreter (spittle_tpu_torch/io/onnx_interp.py) against
the JAX package's numpy one (spittle_tpu/io/onnx_interp.py), op by op, on
graphs written with tests/_onnx_writer.py and read by each package's own
reader, and on a Silero-form graph (both sample-rate branches, two LSTM
layers with carried state) at a small width.

Shape and index ops (and Neg, Relu, Equal, Cast) must give the same dtype
and the same values exactly; f32 arithmetic must agree within 1e-6 of the
output's largest magnitude, f64 within 1e-12; the Silero-form graph's
outputs within 1e-5 (about twenty f32 ops deep, through log and sqrt).
"""

import numpy as np
import pytest
import torch

from spittle_tpu.io import onnx_interp as jinterp
from spittle_tpu.io import onnx_proto as jonnx
from spittle_tpu_torch.io import onnx_interp as tinterp
from spittle_tpu_torch.io import onnx_proto as tonnx

from _onnx_writer import (
    INT64_MAX,
    attribute,
    graph,
    model,
    node,
    silero_form_model,
    small_silero_tree,
    tensor,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(tmp_path, data: bytes):
    path = tmp_path / "g.onnx"
    path.write_bytes(data)
    return jonnx.load_onnx(str(path)), tonnx.load_onnx(str(path))


def _run_both(tmp_path, data: bytes, feeds):
    jg, tg = _graphs(tmp_path, data)
    want = jinterp.OnnxInterpreter(jg).run(dict(feeds))
    got = tinterp.OnnxInterpreter(tg, device="cpu").run(dict(feeds))
    assert list(got) == list(want)
    return got, want


def _check(got, want, exact: bool, rel: float = 1e-6):
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        g = g.numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if exact:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(scale, 1e-30),
                                       err_msg=name)


def _one(op, inputs, inits=(), attrs=(), n_out=1):
    outs = [f"y{i}" for i in range(n_out)]
    return model(graph("g", nodes=[node(op, inputs, outs, attrs=list(attrs))],
                       inits=list(inits),
                       inputs=[i for i in inputs if i and i.startswith("x")],
                       outputs=outs))


RNG = np.random.default_rng(0)
X3 = RNG.standard_normal((2, 3, 5)).astype(np.float32)
POS = (RNG.random((2, 3, 5)) + 0.1).astype(np.float32)
I64 = np.array([[1, -2, 3], [4, 5, -6]], np.int64)


def _i(name, a):
    return tensor(name, np.asarray(a, np.int64))


# (id, model bytes, feeds): ops whose results must be exact.
EXACT = [
    ("identity", _one("Identity", ["x"]), {"x": X3}),
    ("shape", _one("Shape", ["x"]), {"x": X3}),
    ("shape_start", _one("Shape", ["x"], attrs=[attribute("start", i=1)]), {"x": X3}),
    ("gather_axis0", _one("Gather", ["x", "i"], [_i("i", [1, 0, 1])]), {"x": X3}),
    ("gather_axis1_2d", _one("Gather", ["x", "i"], [_i("i", [[0, 2], [-1, 1]])],
                             [attribute("axis", i=1)]), {"x": X3}),
    ("gather_scalar_neg_axis", _one("Gather", ["x", "i"], [_i("i", -1)],
                                    [attribute("axis", i=-1)]), {"x": X3}),
    ("unsqueeze_input", _one("Unsqueeze", ["x", "a"], [_i("a", [0, 3])]), {"x": X3}),
    ("unsqueeze_attr", _one("Unsqueeze", ["x"], attrs=[attribute("axes", ints=[-1])]),
     {"x": X3}),
    ("squeeze_axes", _one("Squeeze", ["x", "a"], [_i("a", [1])]),
     {"x": X3[:, :1]}),
    ("squeeze_all", _one("Squeeze", ["x"]), {"x": X3[:1, :, :1]}),
    ("concat", _one("Concat", ["x", "xb"], attrs=[attribute("axis", i=-1)]),
     {"x": X3, "xb": X3[..., :2]}),
    ("reshape", _one("Reshape", ["x", "s"], [_i("s", [5, -1])]), {"x": X3}),
    ("pad_constant", _one("Pad", ["x", "p"], [_i("p", [0, 1, 2, 1, 0, 3])]), {"x": X3}),
    ("pad_reflect", _one("Pad", ["x", "p"], [_i("p", [0, 0, 3, 0, 2, 4])],
                         [attribute("mode", s=b"reflect")]), {"x": X3}),
    ("pad_edge", _one("Pad", ["x", "p"], [_i("p", [1, 0, 2, 0, 2, 1])],
                      [attribute("mode", s=b"edge")]), {"x": X3}),
    ("equal", _one("Equal", ["x", "xb"]), {"x": I64, "xb": np.array([1, 5, 3], np.int64)}),
    ("cast_int32", _one("Cast", ["x"], attrs=[attribute("to", i=6)]), {"x": 7 * X3}),
    ("cast_f64", _one("Cast", ["x"], attrs=[attribute("to", i=11)]), {"x": X3}),
    ("cast_from_int64", _one("Cast", ["x"], attrs=[attribute("to", i=1)]), {"x": I64}),
    ("cast_bool", _one("Cast", ["x"], attrs=[attribute("to", i=9)]),
     {"x": np.array([0.0, 1.5, -2.0, 0.0], np.float32)}),
    ("slice_step", _one("Slice", ["x", "s", "e", "a", "t"],
                        [_i("s", [1]), _i("e", [INT64_MAX]), _i("a", [2]), _i("t", [2])]),
     {"x": X3}),
    ("slice_negative_step", _one("Slice", ["x", "s", "e", "a", "t"],
                                 [_i("s", [-1]), _i("e", [-(1 << 63)]), _i("a", [-1]),
                                  _i("t", [-2])]), {"x": X3}),
    ("slice_no_axes", _one("Slice", ["x", "s", "e"], [_i("s", [0, -2]), _i("e", [1, 3])]),
     {"x": X3}),
    ("transpose", _one("Transpose", ["x"], attrs=[attribute("perm", ints=[2, 0, 1])]),
     {"x": X3}),
    ("transpose_reverse", _one("Transpose", ["x"]), {"x": X3}),
    ("constantofshape_value", _one("ConstantOfShape", ["s"], [_i("s", [2, 3])],
                                   [attribute("value", t=np.array([7], np.int64))]), {}),
    ("constantofshape_default", _one("ConstantOfShape", ["s"], [_i("s", [4])]), {}),
    ("neg", _one("Neg", ["x"]), {"x": X3}),
    ("relu", _one("Relu", ["x"]), {"x": X3}),
    ("relu_int", _one("Relu", ["x"]), {"x": I64}),
]

# (id, model bytes, feeds): f32 arithmetic, within 1e-6 of the largest |y|.
ARITH = [
    ("pow", _one("Pow", ["x", "e"], [tensor("e", np.float32(2.0))]), {"x": X3}),
    ("pow_tensor", _one("Pow", ["x", "xb"]), {"x": POS, "xb": X3}),
    ("add_broadcast", _one("Add", ["x", "xb"]), {"x": X3, "xb": X3[0, :, :1]}),
    ("mul", _one("Mul", ["x", "xb"]), {"x": X3, "xb": POS}),
    ("sqrt", _one("Sqrt", ["x"]), {"x": POS}),
    ("log", _one("Log", ["x"]), {"x": POS}),
    ("sigmoid", _one("Sigmoid", ["x"]), {"x": 4 * X3}),
    ("reducemean_axes", _one("ReduceMean", ["x"], attrs=[attribute("axes", ints=[1, -1])]),
     {"x": X3}),
    ("reducemean_nokeep", _one("ReduceMean", ["x"], attrs=[
        attribute("axes", ints=[0]), attribute("keepdims", i=0)]), {"x": X3}),
    ("reducemean_all", _one("ReduceMean", ["x"]), {"x": X3}),
    ("conv", _one("Conv", ["x", "w", "b"],
                  [tensor("w", RNG.standard_normal((4, 3, 3)).astype(np.float32)),
                   tensor("b", RNG.standard_normal(4).astype(np.float32))],
                  [attribute("pads", ints=[1, 2]), attribute("strides", ints=[2])]),
     {"x": RNG.standard_normal((2, 3, 17)).astype(np.float32)}),
    ("conv_groups_dilation", _one("Conv", ["x", "w"],
                                  [tensor("w", RNG.standard_normal((6, 1, 3)).astype(
                                      np.float32))],
                                  [attribute("group", i=3), attribute("dilations", ints=[2]),
                                   attribute("pads", ints=[2, 2])]),
     {"x": RNG.standard_normal((2, 3, 11)).astype(np.float32)}),
]


@pytest.mark.parametrize("case", EXACT, ids=[c[0] for c in EXACT])
def test_exact_ops_match_reference(tmp_path, case):
    _, data, feeds = case
    _check(*_run_both(tmp_path, data, feeds), exact=True)


@pytest.mark.parametrize("case", ARITH, ids=[c[0] for c in ARITH])
def test_f32_ops_match_reference(tmp_path, case):
    _, data, feeds = case
    _check(*_run_both(tmp_path, data, feeds), exact=False)


@pytest.mark.parametrize("cond", [True, False])
def test_if_takes_the_branch_and_its_initializers(tmp_path, cond):
    then_g = graph("then", nodes=[node("Add", ["x", "k"], ["t_out"])],
                   inits=[tensor("k", np.float32(10.0))], outputs=["t_out"])
    else_g = graph("else", nodes=[node("Neg", ["x"], ["e_out"]),
                                  node("Shape", ["x"], ["e_shape"])],
                   outputs=["e_out"])
    data = model(graph("g", nodes=[node("If", ["c"], ["y"], attrs=[
        attribute("then_branch", g=then_g), attribute("else_branch", g=else_g)])],
        inputs=["c", "x"], outputs=["y"]))
    _check(*_run_both(tmp_path, data, {"c": np.array([cond]), "x": X3}), exact=True)


@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("with_state", [True, False])
def test_lstm_matches_reference(tmp_path, dtype, rel, with_state):
    rng = np.random.default_rng(3)
    t, n, i, h = 7, 3, 5, 4
    inits = [tensor("W", (0.5 * rng.standard_normal((1, 4 * h, i))).astype(dtype)),
             tensor("R", (0.5 * rng.standard_normal((1, 4 * h, h))).astype(dtype)),
             tensor("B", (0.5 * rng.standard_normal((1, 8 * h))).astype(dtype))]
    inputs = ["x", "W", "R", "B"] + (["", "xh", "xc"] if with_state else [])
    data = _one("LSTM", inputs, inits, [attribute("hidden_size", i=h)], n_out=3)
    feeds = {"x": rng.standard_normal((t, n, i)).astype(dtype)}
    if with_state:
        feeds.update(xh=rng.standard_normal((1, n, h)).astype(dtype),
                     xc=rng.standard_normal((1, n, h)).astype(dtype))
    _check(*_run_both(tmp_path, data, feeds), exact=False, rel=rel)


def test_unknown_op_raises(tmp_path):
    _, tg = _graphs(tmp_path, _one("Softplus", ["x"]))
    with pytest.raises(NotImplementedError, match="Softplus"):
        tinterp.OnnxInterpreter(tg, device="cpu").run({"x": X3})


def test_runs_on_the_card_by_default(tmp_path):
    _, tg = _graphs(tmp_path, _one("Identity", ["x"]))
    if torch.cuda.is_available():
        assert tinterp.OnnxInterpreter(tg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinterp.OnnxInterpreter(tg)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_silero_form_graph_matches_reference(tmp_path, sr):
    rng = np.random.default_rng(7)
    tree16 = small_silero_tree(rng)
    tree8 = small_silero_tree(rng)
    data = silero_form_model(tree16, tree8)
    n, w, h = 3, 256, 8
    feeds = {"input": (0.3 * rng.standard_normal((n, 1, w))).astype(np.float32),
             "sr": np.array([sr], np.int64),
             "h": (0.5 * rng.standard_normal((2, n, h))).astype(np.float32),
             "c": (0.5 * rng.standard_normal((2, n, h))).astype(np.float32)}
    got, want = _run_both(tmp_path, data, feeds)
    assert got["prob"].shape == (n,) and got["hn"].shape == (2, n, h)
    _check(got, want, exact=False, rel=1e-5)
    # The branches differ, so the If took the asked one.
    other = dict(feeds, sr=np.array([24000 - sr], np.int64))
    flipped, _ = _run_both(tmp_path, data, other)
    assert not torch.equal(flipped["prob"], got["prob"])

"""A protobuf writer for ONNX files (no onnx or protobuf package), shared
by the tests of the port's ONNX reader and interpreter: TensorProto,
AttributeProto, NodeProto, GraphProto and ModelProto as bytes."""

import struct

import numpy as np

# ONNX TensorProto.DataType tags of the numpy dtypes.
TAGS = {np.float32: 1, np.uint8: 2, np.int8: 3, np.uint16: 4, np.int16: 5,
        np.int32: 6, np.int64: 7, np.bool_: 9, np.float16: 10, np.float64: 11,
        np.uint32: 12, np.uint64: 13}
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




def model(top: bytes) -> bytes:
    """ModelProto: ir_version 8, a producer name and the graph."""
    return vfield(1, 8) + lfield(2, "test") + lfield(7, top)


# -- a Silero-form graph -------------------------------------------------------

# Slice's "to the end" sentinel, as exporters write it (INT64_MAX).
INT64_MAX = (1 << 63) - 1


def _c(name, a):
    return tensor(name, np.asarray(a))


def _sep_block(p, x, blk, out, nodes, inits):
    """Depthwise (k 5) -> relu -> pointwise, + (proj | identity), relu."""
    c = blk["dw_w"].shape[0]
    for k in ("dw_w", "dw_b", "pw_w", "pw_b", "proj_w", "proj_b"):
        if k in blk:
            inits.append(_c(f"{out}.{k}", blk[k]))
    nodes += [
        node("Conv", [x, f"{out}.dw_w", f"{out}.dw_b"], [f"{out}.dw"],
             attrs=[attribute("group", i=c), attribute("pads", ints=[2, 2])]),
        node("Relu", [f"{out}.dw"], [f"{out}.dwr"]),
        node("Conv", [f"{out}.dwr", f"{out}.pw_w", f"{out}.pw_b"], [f"{out}.pw"]),
    ]
    res = x
    if "proj_w" in blk:
        nodes.append(node("Conv", [x, f"{out}.proj_w", f"{out}.proj_b"],
                          [f"{out}.res"]))
        res = f"{out}.res"
    nodes += [node("Add", [f"{out}.pw", res], [f"{out}.sum"]),
              node("Relu", [f"{out}.sum"], [out])]


def silero_form_branch(p: str, tree) -> bytes:
    """One sample-rate branch of a Silero-form graph over Silero's weight
    tree (audio/vad/silero.py's npz layout): reflect Pad -> STFT Conv ->
    magnitude (Slice, Pow, Add, Sqrt) -> log -> adaptive normalization
    (ReduceMean, reflect Pad, Conv, Neg, Add) -> Concat -> the separable
    conv blocks and strided Convs with Relu -> Transpose -> two LSTM layers
    whose h/c come from the outer inputs "h" and "c" [2, N, H] (Gather,
    Unsqueeze) and are carried out (Concat) -> Relu -> the head Conv ->
    Sigmoid -> ReduceMean over time -> Reshape. Outputs p.prob [N], p.hn
    and p.cn [2, N, H]."""
    k = tree["stft_basis"].shape[-1]
    f = tree["stft_basis"].shape[0] // 2
    stride, pad = k // 4, 3 * k // 8
    hidden = tree["lstm"][0]["r"].shape[1]
    inits = [_c(f"{p}.stft", tree["stft_basis"]), _c(f"{p}.norm", tree["norm_filter"]),
             _c(f"{p}.pads_stft", [0, 0, pad, 0, 0, pad]),
             _c(f"{p}.pads_norm", [0, 0, 3, 0, 0, 3]),
             _c(f"{p}.lo", [0]), _c(f"{p}.mid", [f]), _c(f"{p}.end", [INT64_MAX]),
             _c(f"{p}.axis1", [1]), _c(f"{p}.two", np.float32(2.0)),
             _c(f"{p}.scale", np.float32(1048576.0)), _c(f"{p}.one", np.float32(1.0)),
             _c(f"{p}.flat", [-1]), _c(f"{p}.i0", np.int64(0)), _c(f"{p}.i1", np.int64(1)),
             _c(f"{p}.ax0", [0]), _c(f"{p}.head_w", tree["head_w"]),
             _c(f"{p}.head_b", tree["head_b"])]
    reflect = attribute("mode", s=b"reflect")
    nodes = [
        node("Pad", ["input", f"{p}.pads_stft"], [f"{p}.xp"], attrs=[reflect]),
        node("Conv", [f"{p}.xp", f"{p}.stft"], [f"{p}.spec"],
             attrs=[attribute("strides", ints=[stride])]),
        node("Slice", [f"{p}.spec", f"{p}.lo", f"{p}.mid", f"{p}.axis1"], [f"{p}.re"]),
        node("Slice", [f"{p}.spec", f"{p}.mid", f"{p}.end", f"{p}.axis1"], [f"{p}.im"]),
        node("Pow", [f"{p}.re", f"{p}.two"], [f"{p}.re2"]),
        node("Pow", [f"{p}.im", f"{p}.two"], [f"{p}.im2"]),
        node("Add", [f"{p}.re2", f"{p}.im2"], [f"{p}.pw"]),
        node("Sqrt", [f"{p}.pw"], [f"{p}.mag"]),
        node("Mul", [f"{p}.mag", f"{p}.scale"], [f"{p}.m1"]),
        node("Add", [f"{p}.m1", f"{p}.one"], [f"{p}.m2"]),
        node("Log", [f"{p}.m2"], [f"{p}.spect"]),
        node("ReduceMean", [f"{p}.spect"], [f"{p}.mean"],
             attrs=[attribute("axes", ints=[1]), attribute("keepdims", i=1)]),
        node("Pad", [f"{p}.mean", f"{p}.pads_norm"], [f"{p}.meanp"], attrs=[reflect]),
        node("Conv", [f"{p}.meanp", f"{p}.norm"], [f"{p}.smooth"]),
        node("ReduceMean", [f"{p}.smooth"], [f"{p}.sm"],
             attrs=[attribute("axes", ints=[-1]), attribute("keepdims", i=1)]),
        node("Neg", [f"{p}.sm"], [f"{p}.nsm"]),
        node("Add", [f"{p}.spect", f"{p}.nsm"], [f"{p}.normed"]),
        node("Concat", [f"{p}.mag", f"{p}.normed"], [f"{p}.feat"],
             attrs=[attribute("axis", i=1)]),
    ]
    _sep_block(p, f"{p}.feat", tree["first"], f"{p}.b0", nodes, inits)
    x = f"{p}.b0"
    for i, (betw, blk) in enumerate(zip(tree["between"][:3], tree["blocks"])):
        inits += [_c(f"{p}.bw{i}", betw["w"]), _c(f"{p}.bb{i}", betw["b"])]
        nodes += [node("Conv", [x, f"{p}.bw{i}", f"{p}.bb{i}"], [f"{p}.c{i}"],
                       attrs=[attribute("strides", ints=[2])]),
                  node("Relu", [f"{p}.c{i}"], [f"{p}.r{i}"])]
        _sep_block(p, f"{p}.r{i}", blk, f"{p}.b{i + 1}", nodes, inits)
        x = f"{p}.b{i + 1}"
    last = tree["between"][3]
    inits += [_c(f"{p}.bw3", last["w"]), _c(f"{p}.bb3", last["b"])]
    nodes += [node("Conv", [x, f"{p}.bw3", f"{p}.bb3"], [f"{p}.c3"]),
              node("Relu", [f"{p}.c3"], [f"{p}.feats"]),
              node("Transpose", [f"{p}.feats"], [f"{p}.seq0"],
                   attrs=[attribute("perm", ints=[2, 0, 1])])]
    seq = f"{p}.seq0"
    for layer, lp in enumerate(tree["lstm"]):
        pre = f"{p}.l{layer}"
        inits += [_c(f"{pre}.W", lp["w"][None]), _c(f"{pre}.R", lp["r"][None]),
                  _c(f"{pre}.B", lp["b"][None])]
        for s in ("h", "c"):
            nodes += [node("Gather", [s, f"{p}.i{layer}"], [f"{pre}.{s}g"],
                           attrs=[attribute("axis", i=0)]),
                      node("Unsqueeze", [f"{pre}.{s}g", f"{p}.ax0"], [f"{pre}.{s}0"])]
        nodes += [node("LSTM", [seq, f"{pre}.W", f"{pre}.R", f"{pre}.B", "",
                                f"{pre}.h0", f"{pre}.c0"],
                       [f"{pre}.Y", f"{pre}.hn", f"{pre}.cn"],
                       attrs=[attribute("hidden_size", i=hidden)]),
                  node("Squeeze", [f"{pre}.Y", f"{p}.axis1"], [f"{pre}.out"])]
        seq = f"{pre}.out"
    nodes += [
        node("Concat", [f"{p}.l0.hn", f"{p}.l1.hn"], [f"{p}.hn"],
             attrs=[attribute("axis", i=0)]),
        node("Concat", [f"{p}.l0.cn", f"{p}.l1.cn"], [f"{p}.cn"],
             attrs=[attribute("axis", i=0)]),
        node("Relu", [seq], [f"{p}.yr"]),
        node("Transpose", [f"{p}.yr"], [f"{p}.yt"], attrs=[attribute("perm", ints=[1, 2, 0])]),
        node("Conv", [f"{p}.yt", f"{p}.head_w", f"{p}.head_b"], [f"{p}.logit"]),
        node("Sigmoid", [f"{p}.logit"], [f"{p}.pr"]),
        node("ReduceMean", [f"{p}.pr"], [f"{p}.pm"],
             attrs=[attribute("axes", ints=[2]), attribute("keepdims", i=0)]),
        node("Reshape", [f"{p}.pm", f"{p}.flat"], [f"{p}.prob"]),
    ]
    return graph(f"{p}_graph", nodes=nodes, inits=inits,
                 outputs=[f"{p}.prob", f"{p}.hn", f"{p}.cn"])


def silero_form_model(tree16, tree8) -> bytes:
    """A Silero-form ONNX model: Equal(sr, 16000) picks the 16 kHz branch
    (tree16's weights) or the 8 kHz one (tree8's), each a
    silero_form_branch. Inputs: input [N, 1, W] f32, sr [1] int64, h and c
    [2, N, H] f32; outputs prob [N], hn and cn [2, N, H]."""
    top = graph("silero_form", nodes=[
        node("Equal", ["sr", "sr16k"], ["is16k"]),
        node("If", ["is16k"], ["prob", "hn", "cn"], attrs=[
            attribute("then_branch", g=silero_form_branch("b16", tree16)),
            attribute("else_branch", g=silero_form_branch("b8", tree8))]),
    ], inits=[_c("sr16k", np.array([16000], np.int64))],
        inputs=["input", "sr", "h", "c"], outputs=["prob", "hn", "cn"])
    return model(top)


def small_silero_tree(rng, k=32, widths=(4, 6, 8), hidden=8, scale=0.3):
    """A seeded Silero-layout tree at a small width: an STFT basis of
    k-sample kernels (k // 2 + 1 bins), blocks widths[0] -> widths[1] ->
    widths[1] -> widths[2], LSTM of `hidden` units."""
    def w(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    f = k // 2 + 1
    c0, c1, c2 = widths

    def block(cin, cout):
        b = {"dw_w": w(cin, 1, 5), "dw_b": w(cin), "pw_w": w(cout, cin, 1),
             "pw_b": w(cout)}
        if cin != cout:
            b.update(proj_w=w(cout, cin, 1), proj_b=w(cout))
        return b

    return {
        "stft_basis": w(2 * f, 1, k), "norm_filter": w(1, 1, 7),
        "first": block(2 * f, c0),
        "between": [{"w": w(c, c, 1), "b": w(c)} for c in (c0, c1, c1, c2)],
        "blocks": [block(c0, c1), block(c1, c1), block(c1, c2)],
        "lstm": [{"w": w(4 * hidden, c2 if i == 0 else hidden),
                  "r": w(4 * hidden, hidden), "b": w(8 * hidden)} for i in range(2)],
        "head_w": w(1, hidden, 1), "head_b": w(1),
    }

"""The operator cases of the port's sweep: for each registered op of the
JAX package's ops/{math,tensor,extra,init_ops,random_ops,nn}.py and
`_contrib_flash_attention`, seeded numpy inputs and params (several
variants where the op has modes), the tolerance class of the comparison,
and whether its gradient is compared; for the random ops, the params of
10^4 draws compared by mean and variance.

Used by tests/test_torch_ops_*.py (the port against the JAX package on
the CPU) and by chip_smoke.py's nd_sweep phase (the port on the card
against the port on the CPU). It imports numpy only.

Tolerance classes, relative to the output's scale (max(1, max |want|));
integer and boolean results compare exactly:

- "elem": elementwise, shape and indexing ops: 1e-6;
- "reduce": reductions and normalizations: 1e-5;
- "gemm": GEMM- and convolution-based ops: 1e-4.
"""
import zlib

import numpy as np

TOL = {"elem": 1e-6, "reduce": 1e-5, "gemm": 1e-4}

# JAX-registered ops the port leaves for later (ROADMAP A10): the sparse
# ops and the fused RNN of the six modules the sweep covers. Every op of
# ops/{contrib,vision,control_flow,quantization}.py and of operator.py
# waits too.
DEFERRED = ("_sparse_adagrad_update", "_contrib_SparseEmbedding",
            "cast_storage", "_sparse_retain", "RNN")
DEFERRED_MODULES = ("contrib", "vision", "control_flow", "quantization",
                    "operator")
SWEPT_MODULES = ("math", "tensor", "extra", "init_ops", "random_ops", "nn",
                 "pallas_kernels")


def rng_for(name):
    return np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))


def f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# the case table: name -> (make_inputs(rng) -> [arrays], [params variants],
# tolerance class, grad?, options)
# ---------------------------------------------------------------------------
CASES = {}


def case(name, make, variants=({},), tol="elem", grad=True, **opts):
    assert name not in CASES, name
    CASES[name] = (make, list(variants), tol, grad, opts)


def U(shape, lo=-2.0, hi=2.0):
    return lambda r: [f32(r.uniform(lo, hi, shape))]


def ints(r, shape, hi):
    return f32(r.randint(0, hi, shape))


# -- math ------------------------------------------------------------------
_POS = ("log", "log2", "log10", "sqrt", "rsqrt", "gammaln", "gamma")
_UNIT = ("arcsin", "arccos", "arctanh", "erfinv")
for _n in ("abs", "sign", "ceil", "floor", "rint", "round", "trunc", "fix",
           "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt", "cbrt",
           "square", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
           "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
           "degrees", "radians", "erf", "erfinv", "gammaln", "negative",
           "reciprocal", "rsqrt", "rcbrt", "relu", "sigmoid", "softsign",
           "gamma"):
    if _n in _POS:
        _mk = U((3, 4), 0.5, 2.0)
    elif _n in _UNIT:
        _mk = U((3, 4), -0.8, 0.8)
    elif _n == "arccosh":
        _mk = U((3, 4), 1.2, 3.0)
    elif _n in ("cbrt", "rcbrt", "reciprocal"):
        _mk = (lambda r: [f32(np.sign(r.uniform(-1, 1, (3, 4))) *
                              r.uniform(0.2, 2.0, (3, 4)))])
    elif _n == "log1p":
        _mk = U((3, 4), -0.5, 2.0)
    else:
        _mk = U((3, 4))
    case(_n, _mk)
case("logical_not", lambda r: [ints(r, (3, 4), 3)], grad=False)
case("clip", U((3, 4)), [{"a_min": -0.5, "a_max": 0.5}])
case("BlockGrad", U((3, 4)))
case("identity", U((3, 4)))
case("Cast", U((3, 4)), [{"dtype": "float16"}, {"dtype": "int32"}],
     grad=False)
case("zeros_like", U((3, 4)))
case("ones_like", U((3, 4)))
case("shape_array", U((2, 3, 4)), grad=False)
case("size_array", U((2, 3, 4)), grad=False)
for _n in ("add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
           "hypot"):
    case("broadcast_" + _n, lambda r: [f32(r.uniform(0.5, 2.0, (3, 4))),
                                       f32(r.uniform(0.5, 2.0, (1, 4)))])
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    case("broadcast_" + _n, lambda r: [ints(r, (3, 4), 3),
                                       ints(r, (1, 4), 3)], grad=False)
for _n in ("plus", "minus", "mul", "div", "mod", "power", "maximum",
           "minimum", "hypot"):
    case("_%s_scalar" % _n, U((3, 4), 0.5, 2.5), [{"scalar": 1.5}])
for _n in ("minus", "div", "mod", "power"):
    case("_r%s_scalar" % _n, U((3, 4), 0.5, 2.5), [{"scalar": 1.5}])
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal"):
    case("_%s_scalar" % _n, lambda r: [ints(r, (3, 4), 3)],
         [{"scalar": 1.0}], grad=False)
case("smooth_l1", U((3, 4)), [{"scalar": 1.0}, {"scalar": 2.0}])
for _n in ("sum", "mean", "prod", "max", "min"):
    case(_n, U((2, 3, 4), 0.5, 1.5),
         [{"axis": (0, 2)}, {}, {"axis": 1, "keepdims": True},
          {"axis": 1, "exclude": True}], tol="reduce")


def _with_nan(r):
    x = f32(r.uniform(0.5, 1.5, (2, 3, 4)))
    x[0, 1, 2] = np.nan
    return [x]


case("nansum", _with_nan, [{"axis": (0, 2)}, {}], tol="reduce")
case("nanprod", _with_nan, [{"axis": 1}, {}], tol="reduce")
case("norm", U((3, 4)), [{}, {"ord": 1, "axis": 1}], tol="reduce")
case("argmax", U((3, 5)), [{"axis": 1}, {}], grad=False)
case("argmin", U((3, 5)), [{"axis": 0}], grad=False)
case("argmax_channel", U((3, 5)), grad=False)
case("broadcast_to", U((1, 4)), [{"shape": (3, 0)}])
case("broadcast_axis", U((1, 4)), [{"axis": 0, "size": 3}])
case("broadcast_like", lambda r: [f32(r.rand(1, 4)), f32(r.rand(3, 4))])
case("khatri_rao", lambda r: [f32(r.rand(2, 3)), f32(r.rand(4, 3))],
     tol="gemm")
case("cumsum", U((3, 4)), [{"axis": 1}, {}], tol="reduce")
case("logsumexp", U((3, 4)), [{"axis": 1}, {}], tol="reduce")

# -- tensor ----------------------------------------------------------------
case("Reshape", U((2, 3, 4)),
     [{"shape": (0, -1)}, {"shape": (-3, 0)}, {"shape": (-4, 1, 2, -2)},
      {"shape": (-2,)}, {"shape": (4, -1), "reverse": True}])
case("Flatten", U((2, 3, 4)))
case("transpose", U((2, 3, 4)), [{"axes": (2, 0, 1)}, {}])
case("expand_dims", U((2, 3)), [{"axis": 1}, {"axis": -1}])
case("squeeze", U((2, 1, 3, 1)), [{"axis": 1}, {}])
case("swapaxes", U((2, 3, 4)), [{"dim1": 0, "dim2": 2}])
case("reshape_like", lambda r: [f32(r.rand(2, 6)), f32(r.rand(3, 4))])
case("slice", U((4, 5)),
     [{"begin": (1, 0), "end": (3, 5), "step": (1, 2)},
      {"begin": (3, None), "end": (0, None), "step": (-1, None)}])
case("slice_axis", U((3, 5)), [{"axis": 1, "begin": 1, "end": 4},
                               {"axis": 0, "begin": -2, "end": None}])
case("slice_like", lambda r: [f32(r.rand(4, 6)), f32(r.rand(2, 3))],
     [{}, {"axes": (1,)}])
case("Concat", lambda r: [f32(r.rand(2, 3)), f32(r.rand(2, 2)),
                          f32(r.rand(2, 1))], [{"dim": 1}])
case("stack", lambda r: [f32(r.rand(2, 3)) for _ in range(3)],
     [{"axis": 1}])
case("SliceChannel", U((2, 6)), [{"num_outputs": 3, "axis": 1},
                                 {"num_outputs": 2, "axis": 0,
                                  "squeeze_axis": True}])
case("tile", U((2, 3)), [{"reps": (2, 1)}, {"reps": (2,)}])
case("repeat", U((2, 3)), [{"repeats": 2, "axis": 0}, {"repeats": 2}])
case("Pad", U((1, 2, 3, 3)),
     [{"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2),
       "constant_value": 0.5},
      {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
      {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}])
case("flip", U((2, 3, 4)), [{"axis": 1}, {"axis": (0, 2)}])
case("space_to_depth", U((1, 2, 4, 4)), [{"block_size": 2}])
case("depth_to_space", U((1, 8, 2, 2)), [{"block_size": 2}])
case("take", lambda r: [f32(r.rand(5, 3)), f32([0, 4, 2, 7])],
     [{"axis": 0}, {"axis": 0, "mode": "wrap"}])
case("batch_take", lambda r: [f32(r.rand(4, 5)), f32([0, 2, 4, 1])],
     [{}, {"keepdims": True}])
case("Embedding", lambda r: [ints(r, (2, 3), 10), f32(r.rand(10, 4))],
     [{"input_dim": 10, "output_dim": 4}])
case("one_hot", lambda r: [f32([0, 2, 1, 5])],
     [{"depth": 4}, {"depth": 4, "on_value": 2.0, "off_value": -1.0}],
     grad=False)
case("gather_nd", lambda r: [f32(r.rand(3, 4)), f32([[0, 2, 1],
                                                     [3, 0, 1]])])
case("scatter_nd", lambda r: [f32(r.rand(3)), f32([[0, 2, 1], [3, 0, 1]])],
     [{"shape": (3, 4)}])
case("_scatter_set_nd", lambda r: [f32(r.rand(3, 3)), f32([[0, 2], [1, 0]]),
                                   f32(r.rand(2))], [{"shape": (3, 3)}])
case("where", lambda r: [ints(r, (3, 4), 2), f32(r.rand(3, 4)),
                         f32(r.rand(3, 4))])
case("ravel_multi_index", lambda r: [f32([[1, 2, 0], [3, 1, 4]])],
     [{"shape": (4, 5)}], grad=False)
case("unravel_index", lambda r: [f32([0, 7, 13, 19])], [{"shape": (4, 5)}],
     grad=False)
case("topk", U((3, 5)),
     [{"k": 2}, {"k": 2, "ret_typ": "value"}, {"k": 3, "ret_typ": "both"},
      {"k": 2, "ret_typ": "mask", "axis": 0},
      {"k": 2, "ret_typ": "value", "is_ascend": True}], grad=False)
case("sort", U((3, 5)), [{}, {"is_ascend": False, "axis": 0}])
case("argsort", U((3, 5)), [{}, {"is_ascend": False}], grad=False)
case("dot", lambda r: [f32(r.rand(3, 4)), f32(r.rand(4, 5))],
     [{}, {"transpose_a": True, "transpose_b": True,
           "_inputs": lambda r: [f32(r.rand(4, 3)), f32(r.rand(5, 4))]},
      {"_inputs": lambda r: [f32(r.rand(2, 3, 4)), f32(r.rand(4, 5))]}],
     tol="gemm")
case("batch_dot", lambda r: [f32(r.rand(2, 3, 4)), f32(r.rand(2, 4, 3))],
     [{}, {"transpose_a": True, "transpose_b": True}], tol="gemm")


def _spd(r, n=3, batch=2):
    a = r.rand(batch, n, n)
    return f32(a @ a.transpose(0, 2, 1) + n * np.eye(n))


def _lower(r, n=3, batch=2):
    a = np.tril(r.rand(batch, n, n)) + 2 * np.eye(n)
    return f32(a)


case("_linalg_gemm", lambda r: [f32(r.rand(2, 3, 4)), f32(r.rand(2, 4, 5)),
                                f32(r.rand(2, 3, 5))],
     [{"alpha": 1.5, "beta": 0.5}], tol="gemm")
case("_linalg_gemm2", lambda r: [f32(r.rand(2, 4, 3)), f32(r.rand(2, 4, 5))],
     [{"transpose_a": True, "alpha": 2.0}], tol="gemm")
case("_linalg_potrf", lambda r: [_spd(r)], tol="gemm")
case("_linalg_potri", lambda r: [_lower(r)], tol="gemm")
case("_linalg_trsm", lambda r: [_lower(r), f32(r.rand(2, 3, 4))],
     [{}, {"transpose": True, "alpha": 2.0}], tol="gemm")
case("_linalg_trmm", lambda r: [_lower(r), f32(r.rand(2, 3, 4))],
     [{}, {"transpose": True}], tol="gemm")
case("_linalg_syrk", lambda r: [f32(r.rand(2, 3, 4))],
     [{}, {"transpose": True, "alpha": 0.5}], tol="gemm")
case("_linalg_sumlogdiag", lambda r: [_spd(r)], tol="gemm")
# eigenvectors and the QR factors are fixed up to the sign of each row:
# compared by absolute value, and not differentiated
case("_linalg_syevd", lambda r: [_spd(r)], tol="gemm", grad=False,
     up_to_sign=True)
case("_linalg_gelqf", lambda r: [f32(r.rand(3, 4))], tol="gemm",
     grad=False, up_to_sign=True)
for _n in ("SequenceMask", "SequenceLast", "SequenceReverse"):
    case(_n, lambda r: [f32(r.rand(4, 2, 3)), f32([2, 4])],
         [{"use_sequence_length": True}, {}])
case("diag", U((4, 4)), [{}, {"k": 1}])
case("histogram", U((20,), 0.0, 1.0), [{"bin_cnt": 5, "range": (0.0, 1.0)}],
     grad=False)

# -- init_ops --------------------------------------------------------------
case("_zeros", lambda r: [], [{"shape": (2, 3)}], grad=False)
case("_ones", lambda r: [], [{"shape": (2, 3)}], grad=False)
case("_full", lambda r: [], [{"shape": (2, 2), "value": 7.0}], grad=False)
case("_arange", lambda r: [], [{"start": 2.0, "stop": 8.0, "step": 1.5},
                               {"start": 0.0, "stop": 3.0, "repeat": 2}],
     grad=False)
case("_eye", lambda r: [], [{"N": 3}, {"N": 3, "M": 4, "k": 1}],
     grad=False)

# -- extra -----------------------------------------------------------------


def _upd(*extra_shapes, dtype=np.float32):
    def make(r):
        w = f32(r.uniform(-1, 1, (4, 3))).astype(dtype)
        g = f32(r.uniform(-1, 1, (4, 3))).astype(dtype)
        return [w, g] + [f32(r.uniform(0.1, 1, (4, 3))) if pos else
                         f32(r.uniform(-0.5, 0.5, (4, 3)))
                         for pos in extra_shapes]
    return make


_HP = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}
case("sgd_update", _upd(), [_HP, dict(_HP, clip_gradient=0.2)], grad=False)
case("sgd_mom_update", _upd(False),
     [dict(_HP, momentum=0.9), dict(_HP, momentum=0.9, clip_gradient=0.2),
      dict(_HP)], grad=False)


def _mp(momentum):
    def make(r):
        w32 = f32(r.uniform(-1, 1, (4, 3)))
        g = f32(r.uniform(-1, 1, (4, 3))).astype(np.float16)
        state = [f32(r.uniform(-0.5, 0.5, (4, 3)))] if momentum else []
        return [w32.astype(np.float16), g] + state + [w32]
    return make


# the fp16 weight is the fp32 master's rounding: one fp16 ulp apart at
# most where the two masters differ in their last fp32 place
case("mp_sgd_update", _mp(False), [_HP], grad=False, out_tol=1e-3)
case("mp_sgd_mom_update", _mp(True), [dict(_HP, momentum=0.9)], grad=False,
     out_tol=1e-3)
case("adam_update", _upd(False, True), [dict(_HP, beta1=0.8)], grad=False,
     tol="reduce")
case("rmsprop_update", _upd(True), [_HP, dict(_HP, clip_weights=0.5)],
     grad=False, tol="reduce")
case("rmspropalex_update", _upd(True, False, False), [_HP], grad=False,
     tol="reduce")
case("ftrl_update", _upd(False, True), [_HP], grad=False, tol="reduce")
case("ftml_update", _upd(True, True, False), [dict(_HP, t=2)], grad=False,
     tol="reduce")
case("signsgd_update", _upd(), [_HP], grad=False)
case("signum_update", _upd(False), [dict(_HP, momentum=0.9, wd_lh=0.01)],
     grad=False)
case("add_n", lambda r: [f32(r.rand(2, 3)) for _ in range(3)],
     [{"num_args": 3}])
case("_grad_add", lambda r: [f32(r.rand(2, 3)), f32(r.rand(2, 3))])
case("hard_sigmoid", U((3, 4), -4, 4), [{}, {"alpha": 0.3, "beta": 0.4}])
case("softmax_cross_entropy", lambda r: [f32(r.randn(4, 5)),
                                         f32([0, 3, 4, 1])], tol="reduce")
case("_histogram", U((30,), 0.0, 1.0), [{"bin_cnt": 5, "range": (0.0, 1.0)}],
     grad=False)
case("_ravel_multi_index", lambda r: [f32([[1, 2, 0], [3, 1, 4]])],
     [{"shape": (4, 5)}], grad=False)
case("_unravel_index", lambda r: [f32([0, 7, 13, 19])], [{"shape": (4, 5)}],
     grad=False)
for _n in ("_logical_and", "_logical_or", "_logical_xor"):
    case(_n, lambda r: [ints(r, (3, 4), 3), ints(r, (3, 4), 3)], grad=False)
    case(_n + "_scalar", lambda r: [ints(r, (3, 4), 3)],
         [{"scalar": 1.0}, {"scalar": 0.0}], grad=False)
case("_slice_assign", lambda r: [f32(r.rand(4, 4)), f32(r.rand(2, 2))],
     [{"begin": (1, 1), "end": (3, 3)}])
case("_slice_assign_scalar", U((4, 4)),
     [{"scalar": 5.0, "begin": (1, 0), "end": (3, 4), "step": (1, 2)}])
case("_scatter_plus_scalar", U((3, 4)), [{"scalar": 1.5}])
case("_scatter_minus_scalar", U((3, 4)), [{"scalar": 1.5}])
case("_scatter_elemwise_div", lambda r: [f32(r.rand(3, 4)),
                                         f32(r.uniform(0.5, 2, (3, 4)))])
case("_square_sum", U((3, 4)), [{"axis": 1}, {}], tol="reduce")
case("_identity_with_attr_like_rhs", lambda r: [f32(r.rand(3)),
                                                f32(r.rand(3))])
case("_image_to_tensor", lambda r: [r.randint(0, 256, (4, 5, 3))
                                    .astype(np.uint8)], grad=False)
case("_image_normalize", U((3, 4, 4), 0, 1),
     [{"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}])
case("_contrib_bipartite_matching", lambda r: [f32(r.rand(3, 4))],
     [{"threshold": 0.2}, {"is_ascend": True, "topk": 2}], grad=False)
case("_CrossDeviceCopy", U((2, 2)))

# -- nn --------------------------------------------------------------------
case("Activation", U((2, 3, 4)),
     [{"act_type": t} for t in ("relu", "sigmoid", "tanh", "softrelu",
                                "softsign", "gelu", "silu")])
case("LeakyReLU", lambda r: [f32(r.uniform(-2, 2, (2, 3, 4))),
                             f32(r.uniform(0.1, 0.3, (3,)))],
     [{"act_type": "leaky", "slope": 0.1}, {"act_type": "elu"},
      {"act_type": "selu"}, {"act_type": "prelu"}, {"act_type": "rrelu"}])
case("softmax", U((2, 3, 4)), [{}, {"axis": 1, "temperature": 2.0}],
     tol="reduce")
case("log_softmax", U((2, 3, 4)), [{}, {"axis": 0}], tol="reduce")
case("softmin", U((2, 3, 4)), tol="reduce")
case("SoftmaxActivation", U((2, 3, 4)), [{}, {"mode": "channel"}],
     tol="reduce")
case("SoftmaxOutput", lambda r: [f32(r.randn(4, 5)), f32([0, 3, 4, 1])],
     [{}, {"grad_scale": 2.0, "use_ignore": True, "ignore_label": 3.0,
           "normalization": "valid"},
      {"normalization": "batch"}], tol="reduce", grad_inputs=(0,))
case("LinearRegressionOutput", lambda r: [f32(r.rand(4, 3)),
                                          f32(r.rand(4, 3))],
     [{}, {"grad_scale": 2.0}], grad_inputs=(0,))
case("MAERegressionOutput", lambda r: [f32(r.rand(4, 3)), f32(r.rand(4, 3))],
     grad_inputs=(0,))
case("LogisticRegressionOutput", lambda r: [f32(r.randn(4, 3)),
                                            f32(r.rand(4, 3))],
     grad_inputs=(0,))
case("MakeLoss", U((4, 3)), [{}, {"grad_scale": 3.0,
                                  "normalization": "batch"}])
case("FullyConnected", lambda r: [f32(r.randn(2, 3, 4)),
                                  f32(r.randn(5, 12)), f32(r.randn(5))],
     [{"num_hidden": 5}], tol="gemm")
case("Convolution", lambda r: [f32(r.randn(2, 4, 6, 6)),
                               f32(r.randn(4, 4, 3, 3)), f32(r.randn(4))],
     [{"kernel": (3, 3), "num_filter": 4, "stride": (2, 2), "pad": (1, 1)},
      {"kernel": (3, 3), "num_filter": 4, "num_group": 2, "dilate": (2, 2),
       "no_bias": True, "_inputs": lambda r: [f32(r.randn(2, 4, 7, 7)),
                                              f32(r.randn(4, 2, 3, 3))]},
      {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1), "layout": "NHWC",
       "_inputs": lambda r: [f32(r.randn(2, 6, 6, 4)),
                             f32(r.randn(4, 3, 3, 4)), f32(r.randn(4))]},
      {"kernel": (3,), "num_filter": 4,
       "_inputs": lambda r: [f32(r.randn(2, 4, 8)), f32(r.randn(4, 4, 3)),
                             f32(r.randn(4))]}], tol="gemm")
case("Deconvolution", lambda r: [f32(r.randn(2, 3, 4, 4)),
                                 f32(r.randn(3, 2, 3, 3))],
     [{"kernel": (3, 3), "num_filter": 2, "stride": (2, 2), "pad": (1, 1),
       "adj": (1, 1)}], tol="gemm")
case("Pooling", U((2, 3, 7, 7)),
     [{"kernel": (3, 3), "stride": (2, 2)},
      {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
       "pool_type": "avg", "count_include_pad": False},
      {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"},
      {"kernel": (3, 3), "pool_type": "lp", "p_value": 2},
      {"kernel": (3, 3), "stride": (2, 2), "pooling_convention": "full"},
      {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
       "pool_type": "avg", "pooling_convention": "full"},
      {"global_pool": True, "pool_type": "avg"},
      {"global_pool": True, "pool_type": "max"},
      {"kernel": (3, 3), "stride": (2, 2), "layout": "NHWC"},
      {"kernel": (3,), "stride": (2,), "pool_type": "avg",
       "_inputs": lambda r: [f32(r.randn(2, 3, 9))]}],
     tol="reduce")
case("UpSampling", U((1, 2, 3, 3)),
     [{"scale": 2}, {"scale": 2, "sample_type": "bilinear"}], tol="reduce")


def _bn_inputs(r):
    return [f32(r.randn(4, 3, 5)), f32(r.uniform(0.5, 1.5, 3)),
            f32(r.randn(3)), f32(r.randn(3)), f32(r.uniform(0.5, 1.5, 3))]


case("BatchNorm", _bn_inputs,
     [{"fix_gamma": False}, {"fix_gamma": False, "_train": True},
      {"_train": True, "output_mean_var": True, "momentum": 0.8},
      {"fix_gamma": False, "_train": True, "use_global_stats": True}],
     tol="reduce", grad_inputs=(0, 1, 2))
case("LayerNorm", lambda r: [f32(r.randn(2, 3, 8)), f32(r.rand(8) + 0.5),
                             f32(r.randn(8))], [{}, {"eps": 1e-3}],
     tol="reduce")
case("InstanceNorm", lambda r: [f32(r.randn(2, 3, 4, 4)),
                                f32(r.rand(3) + 0.5), f32(r.randn(3))],
     tol="reduce")
case("L2Normalization", U((2, 3, 4)),
     [{}, {"mode": "channel"}, {"mode": "spatial"}], tol="reduce")
case("LRN", U((2, 5, 3, 3), 0, 1), [{"nsize": 3}], tol="reduce")
case("Dropout", U((2, 3)), [{"p": 0.5}])
case("Correlation", lambda r: [f32(r.randn(1, 2, 6, 6)),
                               f32(r.randn(1, 2, 6, 6))],
     [{"pad_size": 1}, {"kernel_size": 3, "max_displacement": 1,
                        "pad_size": 2, "is_multiply": False}], tol="gemm")
case("IdentityAttachKLSparseReg", U((3, 4)))
case("_contrib_flash_attention",
     lambda r: [f32(r.randn(1, 2, 16, 8)) for _ in range(3)],
     [{"causal": True, "block_q": 8, "block_k": 8},
      {"causal": False, "block_q": 8, "block_k": 8}], tol="gemm")


# the layer-norm variant along a non-last axis: gamma and beta of axis 1
CASES["LayerNorm"][1].append({"axis": 1, "_inputs": lambda r: [
    f32(r.randn(2, 3, 4)), f32(r.rand(3) + 0.5), f32(r.randn(3))]})


# ---------------------------------------------------------------------------
# random ops: name -> (make_inputs(rng), params); 10^4 draws (two rows of
# 5000 for the samplers that take parameter arrays), compared row by row
# by mean and variance within 4 standard errors
# ---------------------------------------------------------------------------
N_DRAWS = 10000
RANDOM = {}


def rcase(name, make, params):
    RANDOM[name] = (make, params)


_S = {"shape": (N_DRAWS,)}
rcase("_random_uniform", lambda r: [], dict(_S, low=-1.0, high=2.0))
rcase("_random_normal", lambda r: [], dict(_S, loc=1.0, scale=2.0))
rcase("_random_gamma", lambda r: [], dict(_S, alpha=2.0, beta=1.5))
rcase("_random_exponential", lambda r: [], dict(_S, lam=2.0))
rcase("_random_poisson", lambda r: [], dict(_S, lam=4.0))
rcase("_random_negative_binomial", lambda r: [], dict(_S, k=3, p=0.4))
rcase("_random_generalized_negative_binomial", lambda r: [],
      dict(_S, mu=2.0, alpha=0.5))
rcase("_random_randint", lambda r: [], dict(_S, low=0, high=10))
rcase("bernoulli", lambda r: [], dict(_S, prob=0.3))
_ROWS = {"shape": (N_DRAWS // 2,)}
rcase("_sample_uniform", lambda r: [f32([0.0, 10.0]), f32([1.0, 20.0])],
      _ROWS)
rcase("_sample_normal", lambda r: [f32([0.0, 5.0]), f32([1.0, 3.0])], _ROWS)
rcase("_sample_multinomial", lambda r: [f32([[0.1, 0.3, 0.6],
                                             [0.5, 0.5, 0.0]])], _ROWS)
rcase("_shuffle", lambda r: [f32(np.arange(N_DRAWS))], {})
rcase("_sample_exponential", lambda r: [f32([1.0, 3.0])], _ROWS)
rcase("_sample_gamma", lambda r: [f32([2.0, 5.0]), f32([1.0, 0.5])], _ROWS)
rcase("_sample_poisson", lambda r: [f32([1.5, 6.0])], _ROWS)
rcase("_sample_negative_binomial", lambda r: [f32([2.0, 4.0]),
                                              f32([0.5, 0.3])], _ROWS)
rcase("_sample_generalized_negative_binomial",
      lambda r: [f32([2.0, 3.0]), f32([0.5, 0.2])], _ROWS)




def case_of(name, get):
    """The case of op `name` (or of the op it aliases, by the registry
    lookup `get`), or None."""
    if name in CASES:
        return CASES[name]
    op = get(name)
    for other in sorted(CASES):
        if get(other) is op:
            return CASES[other]
    return None


def random_case_of(name, get):
    if name in RANDOM:
        return RANDOM[name]
    op = get(name)
    for other in sorted(RANDOM):
        if get(other) is op:
            return RANDOM[other]
    return None


def split_params(params):
    """(op params, training mode?, the variant's own input maker)."""
    params = dict(params)
    train = params.pop("_train", False)
    make = params.pop("_inputs", None)
    return params, train, make


def moments(x):
    x = np.asarray(x, np.float64).reshape(-1)
    m = x.mean()
    c = x - m
    var = (c * c).mean()
    return m, var, (c ** 4).mean(), x.size


def draws_agree(got, want):
    """None when the mean and the variance of `got` lie within 4 standard
    errors of `want`'s, else what differs."""
    mt, vt, m4t, n = moments(got)
    mj, vj, m4j, nj = moments(want)
    se_mean = np.sqrt(vt / n + vj / nj)
    if abs(mt - mj) > 4 * se_mean + 1e-12:
        return "mean %g vs %g (se %g)" % (mt, mj, se_mean)
    se_var = np.sqrt(max(m4t - vt * vt, 0) / n + max(m4j - vj * vj, 0) / nj)
    if abs(vt - vj) > 4 * se_var + 1e-12:
        return "variance %g vs %g (se %g)" % (vt, vj, se_var)
    return None


def compare(got, want, tol, up_to_sign=False):
    """None when `got` matches `want` (dtype, shape; exactly for integer
    and boolean results, else within tol of the output's scale, NaN where
    NaN), else what differs."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return "shape/dtype %s %s vs %s %s" % (got.shape, got.dtype,
                                               want.shape, want.dtype)
    if want.dtype.kind in "iub":
        return None if np.array_equal(got, want) else "values differ"
    g, w = got.astype(np.float64), want.astype(np.float64)
    if up_to_sign:
        g, w = np.abs(g), np.abs(w)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        return "NaN positions differ"
    ok = ~np.isnan(w)
    if not ok.any():
        return None
    scale = max(1.0, float(np.abs(w[ok]).max()))
    err = float(np.abs(g[ok] - w[ok]).max())
    return None if err <= tol * scale else \
        "max error %g > %g x %g" % (err, tol, scale)

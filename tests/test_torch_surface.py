"""The port's surface covers the JAX package's.

The JAX package is read with ``ast`` (nothing of it is imported but its
``config.py``, which imports no JAX), so this runs in seconds. Every
public top-level function or class of ``tensorflow_ocr_tpu/``, every
public method of a public class, every dataclass field of its
``config.py`` and every ``OCR_*`` environment variable it reads through
``os.environ.get`` has a counterpart of the same name in
``tensorflow_ocr_tpu_torch/`` (a method in a class of the same name; a
field in the section of the same name; the same variable read), or
stands in :data:`RENAMED` (its counterpart's name, which must exist) or
:data:`NOT_PORTED` (why the port has none); a config field may instead
be a dotted path that the port's ``parse_flags`` accepts and ignores
(``IGNORED_PATHS``). Every dotted path that JAX's ``parse_flags`` takes
parses in the port's: to the same value, or, for an ignored path, to the
default Config. ``Config.replace`` exists.
"""

import ast
import dataclasses
import pathlib

import pytest

from tensorflow_ocr_tpu import config as J
from tensorflow_ocr_tpu_torch import config as T

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "tensorflow_ocr_tpu"
PORT_PKG = ROOT / "tensorflow_ocr_tpu_torch"

# JAX name -> the port's counterpart (a top-level name, or Class.method)
RENAMED = {
    "kernel_mask": "kernel_names",
    "ema_decay_schedule": "ema_decay",
    "slim_to_flax_key": "slim_to_torch_key",
    "max_pool_3x3s2": "stem_max_pool",
    "polygon_area_jax": "polygon_area_torch",
    "sort_rectangle_jax": "sort_rectangle_torch",
    "restore_rectangle_rbox_jax": "restore_rectangle_rbox_torch",
    # a module global set by a function -> the argument of the backbone
    "set_bottleneck_impl": "ResNetV1.__init__",
    # the Flax modules' factory functions -> the modules' constructors
    "resnet_v1": "ResNetV1.__init__",
    "resnet_v2": "ResNetV2.__init__",
    # a jitted step factory -> the step itself (eager, or captured by
    # make_multi_train_step)
    "make_train_step": "train_step",
    # pallas_kernels.py's CC -> cc.cu's, which reads the (h, w, 8) edges
    # and pairs them itself
    "connected_components_pallas": "connected_components",
    "cc_sweeps_pallas": "connected_components",
    "pack_edges": "connected_components",
    "reference_conv_bn_act": "conv_fwd_reference",
    # Flax's setup -> the module's constructor
    "Detector.setup": "Detector.__init__",
    # the ghost unit's shape test -> the band picker it calls
    "GhostBottleneck.supported": "pick_gh",
    # grain's loader -> the resumable loader (data/resumable.py)
    "CheckpointableLoader": "ResumableLoader",
    "grain_loader": "ResumableLoader",
    # the OpenCV C++ loader -> nvJPEG (data/nvjpeg_loader.py)
    "NativeBatchLoader": "load_batch",
    "native_available": "load_batch",
}

NOT_PORTED = {
    "BNParams": "Flax parameter plumbing: the port's BatchNorm holds its "
                "own parameters",
    "Conv2D": "Flax plumbing: torch.nn.Conv2d",
    "PointwiseConv": "POINTWISE_DOT, a TPU lowering workaround: a 1x1 "
                     "conv is a conv",
    "batch_sharding": "JAX sharding plumbing: a rank holds its rows "
                      "(parallel/mesh.py rank_rows)",
    "replicated_sharding": "JAX sharding plumbing",
    "interpret": "Pallas's interpret mode: the port's plain versions run "
                 "on the CPU",
    "set_interpret": "Pallas's interpret mode",
    "taps": "Pallas helper: the Hopper kernels take their taps in "
            "conv_bwd.cuh",
    "tap_matmul": "Pallas helper",
    "pick_bm": "a VMEM block picker, re-derived for Hopper as the plans "
               "of ops/conv.py",
    "pick_bm_bnd": "a VMEM block picker",
    "pick_th": "a VMEM block picker",
    "machine_scoped_cache_dir": "utils/xla_cache.py: XLA's compilation "
                                "cache",
    "machine_tag": "utils/xla_cache.py",
    "OCR_XLA_OPTS": "XLA's compiler options",
    "OCR_SCAN_UNROLL": "the unroll of XLA's scan: the port replays a CUDA "
                       "graph",
    "OCR_FAST_MAXPOOL": "the equality-mask max-pool VJP, an exact rewrite",
    "OCR_S2D_STEM": "the space-to-depth stem, an exact rewrite",
    "OCR_FUSED_BOTTLENECKS": "an environment A/B switch of the fused units: "
                             "the port takes bottleneck_impl only",
    "OCR_GHOST_UNITS": "an environment A/B switch of the ghost units: the "
                       "port takes bottleneck_impl only",
    "OCR_POOL_BEFORE_RELU": "an exact rewrite: max-pool and relu commute "
                            "in values and subgradients",
}


def surface(root):
    """({public top-level name}, {Class.method} of public classes (every
    method, dunders too, on the port's side), {OCR_* variable read})."""
    names, methods, env = set(), set(), set()
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names.add(node.name)
            if isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_"):
                methods |= {f"{node.name}.{m.name}" for m in node.body
                            if isinstance(m, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and ast.unparse(node.func.value) == "os.environ"
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith("OCR_")):
                env.add(node.args[0].value)
    return names, methods, env


JAX_NAMES, JAX_METHODS, JAX_ENV = surface(JAX_PKG)
PORT_NAMES, PORT_METHODS, PORT_ENV = surface(PORT_PKG)


def public(methods):
    return {m for m in methods if not m.split(".")[1].startswith("_")}


@pytest.mark.parametrize("kind", ["names", "methods", "env"])
def test_jax_surface_has_counterparts(kind):
    jax_side, port_side = {
        "names": (JAX_NAMES, PORT_NAMES),
        # a method of a class the port has; one of a class the port
        # replaces goes with the class
        "methods": ({m for m in public(JAX_METHODS)
                     if m.split(".")[0] in PORT_NAMES}, PORT_METHODS),
        "env": (JAX_ENV, PORT_ENV)}[kind]
    missing = sorted(n for n in jax_side - port_side
                     if n not in RENAMED and n not in NOT_PORTED)
    assert not missing, f"no counterpart in the port and not in the table: " \
                        f"{missing}"


def test_table_is_live():
    """Each table entry names something of the JAX package that the port
    lacks, and each renamed counterpart exists in the port."""
    everything = JAX_NAMES | public(JAX_METHODS) | JAX_ENV
    port = PORT_NAMES | PORT_METHODS | PORT_ENV
    assert not set(RENAMED) & set(NOT_PORTED)
    for name in (*RENAMED, *NOT_PORTED):
        assert name in everything, f"{name} is not in the JAX package"
        assert name not in port, f"{name} is ported under its own name"
    for name, to in RENAMED.items():
        assert to in port, f"{name} -> {to}: not in the port"
    assert "OCR_LOSS_BF16" in PORT_ENV


def dataclass_fields(path):
    """{class name: [field names]} of the dataclasses of a config.py."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef) and any(
                ast.unparse(d) == "dataclass" for d in node.decorator_list):
            out[node.name] = [s.target.id for s in node.body
                              if isinstance(s, ast.AnnAssign)]
    return out


JAX_FIELDS = dataclass_fields(JAX_PKG / "config.py")

SECTIONS = {"DataConfig": "data", "ModelConfig": "model", "LossConfig":
            "loss", "TrainConfig": "train", "InferConfig": "infer",
            "EvalConfig": "eval"}

# JAX's fields that the port has not: dotted paths accepted and ignored
IGNORED = T.IGNORED_PATHS


@pytest.mark.parametrize("section", sorted(JAX_FIELDS))
def test_config_fields_have_counterparts(section):
    """Each of JAX's fields is the port's, or an ignored path; an ignored
    path names a field of JAX's that the port lacks."""
    port = {f.name for f in dataclasses.fields(getattr(T, section))}
    ignored = {path.split(".")[1] for path in IGNORED
               if path.split(".")[0] == SECTIONS.get(section)}
    assert not [f for f in JAX_FIELDS[section]
                if f not in port and f not in ignored]
    assert not ignored & port
    assert ignored <= set(JAX_FIELDS[section])


def flag_value(path, default):
    """A string for ``--path=...`` that the field's type takes and both
    validations accept, other than the default where the type allows."""
    special = {"data.geometry": "QUAD", "train.grad_reduce": "sum",
               "train.optimizer": "momentum", "train.num_devices": "1"}
    if path in special:
        return special[path]
    if isinstance(default, bool):
        return str(not default).lower()
    if isinstance(default, (int, float)):
        return str(default + 1)
    if isinstance(default, (tuple, list)):
        return "0.5,1.5"
    if default is None:
        return "7"
    return "some_value"


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_every_jax_dotted_path_parses_alike(section):
    """``--<section>.<field>=<value>`` through both parse_flags, for every
    field of JAX's section; then ``--flag value`` and a bare ``--flag``
    (true) for its booleans. An ignored path gives the default Config."""
    name = SECTIONS[section]
    for field in dataclasses.fields(getattr(J, section)):
        path = f"{name}.{field.name}"
        default = getattr(getattr(J.Config(), name), field.name)
        raw = flag_value(path, default)
        forms = [[f"--{path}={raw}"], [f"--{path}", raw]]
        if isinstance(default, bool):
            forms.append([f"--{path}"])
        for argv in forms:
            want = getattr(getattr(J.parse_flags(argv), name), field.name)
            if path in IGNORED:
                assert T.parse_flags(argv) == T.Config(), argv
                continue
            got = getattr(getattr(T.parse_flags(argv), name), field.name)
            assert got == want and type(got) is type(want), (argv, got,
                                                              want)


def test_config_replace():
    cfg = T.Config()
    loss = T.LossConfig(compute_dtype="bfloat16")
    new = cfg.replace(loss=loss)
    assert new.loss is loss and new.model is cfg.model
    assert cfg.loss.compute_dtype == "float32"
    with pytest.raises(TypeError):
        cfg.replace(nothing=1)
    jcfg = J.Config().replace(loss=J.LossConfig(compute_dtype="bfloat16"))
    assert jcfg.loss.compute_dtype == new.loss.compute_dtype


@pytest.mark.parametrize("argv", [["--model.bn_momentum=0.9"],
                                  ["--model.bn_epsilon=1e-3"],
                                  ["--train.donate_state=false"],
                                  ["--infer.compat_reference_bugs=true"],
                                  ["--train.xla_options=x"]])
def test_accepted_and_ignored_fields(argv):
    """The five paths of JAX's fields that nothing reads in the port
    parse and change nothing (they raised AttributeError before), beside
    a flag that does change the Config; JAX's takes the value."""
    path = argv[0][2:].split("=")[0]
    assert path in IGNORED
    section, name = path.split(".")
    assert not hasattr(getattr(T.Config(), section), name)
    assert hasattr(getattr(J.parse_flags(argv), section), name)
    assert T.parse_flags(argv) == T.Config()
    cfg = T.parse_flags([*argv, "--train.max_steps=7"])
    assert cfg.train.max_steps == 7
    assert cfg == T.parse_flags(["--train.max_steps=7"])

"""The port's public names against the reference's, on the CPU.

Each name a ``raft_tpu`` package ``__init__`` exports (the top level and
``core``, ``distance``, ``cluster``, ``matrix``, ``neighbors``,
``integrity``, ``resilience``) and each public name of the reference
modules the port has shipped (``core.error``, ``core.resources``,
``core.mdarray``, ``utils.precision``, ``matrix.ops``, and the
persistence slice's ``core.serialize``, ``core.interruptible``,
``core.outputs``, ``config``, ``integrity.canary`` and the four
``resilience`` modules; the filters slice's ``filters`` package and its
``bitset``, ``tenant`` and ``hybrid`` modules, and ``neighbors.mutate``;
the rest of IVF-PQ's ``neighbors.ivf_pq_helpers`` and the primitives'
``random`` package and its ``rng`` and ``generators`` modules; the
host-side subsystems' ``observability`` package and its seven modules,
``core.tracing``, ``core.logger``, ``integrity.verify`` and
``neighbors.delta``; the serving slice's ``serving`` package and its
modules, and ``core.aot``)
resolves in ``raft_tpu_torch`` to the
same kind of object (module, class, function, or a constant of the same
type), or to a stand-in that raises ``NotImplementedError`` naming an
item of ROADMAP.md §1's deferred list.  The ported small names (``fail``,
the precision trio, the ``check_*`` family, the ``make_device_*``
factories, ``Resources``) are held to the reference's behaviour: the same
errors, with the same messages, on the same bad inputs.  A fresh
interpreter imports the port's packages, in an order that would close an
import cycle, without loading jax or raft_tpu.
"""

import ast
import importlib
import pathlib
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import error as jax_error
from raft_tpu.core import mdarray as jax_mdarray
from raft_tpu.core import resources as jax_resources
from raft_tpu.utils import precision as jax_precision
from raft_tpu_torch.core import error, mdarray, resources
from raft_tpu_torch.utils import precision

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ["", ".core", ".distance", ".cluster", ".matrix", ".neighbors",
            ".integrity", ".resilience", ".filters", ".random",
            ".observability", ".serving"]
SHIPPED_MODULES = [".core.error", ".core.resources", ".core.mdarray",
                   ".utils.precision", ".matrix.ops", ".core.serialize",
                   ".core.interruptible", ".core.outputs", ".config",
                   ".integrity.canary", ".resilience.faults",
                   ".resilience.retry", ".resilience.checkpoint",
                   ".resilience.io", ".filters.bitset", ".filters.tenant",
                   ".filters.hybrid", ".neighbors.mutate",
                   ".neighbors.ivf_pq_helpers", ".random.rng",
                   ".random.generators", ".core.tracing", ".core.logger",
                   ".observability.registry", ".observability.stage",
                   ".observability.trace", ".observability.report",
                   ".observability.export", ".observability.flight",
                   ".observability.quality", ".integrity.verify",
                   ".neighbors.delta", ".core.aot", ".serving.buckets",
                   ".serving.admission", ".serving.batcher",
                   ".serving.brownout", ".serving.executor",
                   ".serving.server", ".serving.ingest", ".serving.shadow",
                   ".serving.rebalancer", ".serving.dist_ingest"]


def _deferred_items():
    """The labels of ROADMAP.md §1's deferred list (``- *label*``)."""
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Deferred.**") + len("**Deferred.**")
    block = text[start:text.index("\n1. ", start)]
    return {" ".join(m.split()) for m in re.findall(r"\*([^*]+)\*", block)}


DEFERRED = _deferred_items()


def _exported(package):
    """The names a reference package ``__init__`` binds by its imports."""
    path = ROOT / "raft_tpu" / package.lstrip(".").replace(".", "/") \
        / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


def _public(module):
    """The public names a reference module defines at its top level."""
    path = ROOT / "raft_tpu" / (module.lstrip(".").replace(".", "/") + ".py")
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names += [t.id for t in targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _defined_in(module):
    """A reference module's public attributes that it (or a submodule)
    defines: constants, and functions and classes of its own."""
    own = module.__name__

    def defined(obj):
        if isinstance(obj, (bool, int, float, str, tuple, list, dict)):
            return True
        return str(getattr(obj, "__module__", "")).startswith(own)

    return [n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)
            and defined(getattr(module, n))]


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if isinstance(obj, type):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


def _assert_stub_names_an_item(call):
    """``call()`` raises NotImplementedError naming a deferred item."""
    with pytest.raises(NotImplementedError) as err:
        call()
    msg = str(err.value)
    assert "ROADMAP.md §1" in msg, msg
    named = [item for item in DEFERRED if item in msg]
    assert named, f"{msg!r} names no item of {sorted(DEFERRED)}"


def _assert_counterpart(ref, port_module, name, where):
    try:
        ours = getattr(port_module, name)
    except NotImplementedError:      # a stub module's attribute
        _assert_stub_names_an_item(lambda: getattr(port_module, name))
        return
    except AttributeError:
        pytest.fail(f"{where}.{name} is missing from the port")
    item = (None if isinstance(ours, types.ModuleType)
            else getattr(ours, "not_ported_item", None))
    if item is not None:
        assert item in DEFERRED, f"{where}.{name}: {item!r}"
        _assert_stub_names_an_item(ours)
        return
    assert _kind(ours) == _kind(ref), (
        f"{where}.{name}: {_kind(ours)} in the port, {_kind(ref)} in the "
        f"reference")


def test_the_deferred_list_is_read():
    assert "the tail" in DEFERRED
    # the serving slice's stand-ins wait for distributed/
    assert "distributed (item 7)" in DEFERRED
    # shipped with the persistence slice, with the filters and mutation
    # slice, with the filters of the query-major routes, with the rest of
    # IVF-PQ and the primitives, and with the host-side subsystems: no
    # stand-in may name them
    assert not {"serialization", "canaries", "checkpointing", "filters",
                "mutation", "filters on the query-major routes",
                "primitives", "LUT scan", "InnerProduct search",
                "per-cluster books", "wide recon8 scans",
                "host-side subsystems", "serving"} & DEFERRED


def test_persistence_names_are_the_ported_objects():
    """The names that were stand-ins before the persistence slice are the
    real objects now: none carries a deferred item, and each does what
    its reference does on a small case."""
    import io

    import raft_tpu_torch
    from raft_tpu_torch import config, integrity
    from raft_tpu_torch.core import serialize
    from raft_tpu_torch.core.interruptible import interruptible

    for obj in (raft_tpu_torch.auto_convert_output, integrity.CanarySet,
                integrity.CanaryReport, integrity.health_check,
                config.set_output_as, config.get_output_as,
                serialize.serialize_mdspan, serialize.deserialize_scalar,
                interruptible):
        assert getattr(obj, "not_ported_item", None) is None, obj
    buf = io.BytesIO()
    serialize.serialize_scalar(None, buf, np.int32(7))
    serialize.serialize_mdspan(None, buf, torch.arange(3))
    buf.seek(0)
    assert serialize.deserialize_scalar(None, buf) == 7
    np.testing.assert_array_equal(serialize.deserialize_mdspan(None, buf),
                                  np.arange(3))
    assert config.get_output_as() == "torch"
    assert integrity.health_check(None, object()) is None
    report = integrity.CanaryReport(recall=0.5, floor=0.6, n_queries=2, k=1)
    assert not report.ok


@pytest.mark.parametrize("package", PACKAGES,
                         ids=[p or "top" for p in PACKAGES])
def test_package_exports_resolve_to_the_same_kind(package):
    """Every name the reference package exports, in the port's package:
    the same kind of object, or a stand-in naming its item; an exported
    module that the port stubs raises on its reference's public names."""
    ref_pkg = importlib.import_module("raft_tpu" + package)
    port_pkg = importlib.import_module("raft_tpu_torch" + package)
    names = _exported(package)
    assert names
    for name in names:
        ref = getattr(ref_pkg, name)
        _assert_counterpart(ref, port_pkg, name, "raft_tpu_torch" + package)
        ours = getattr(port_pkg, name)
        if (isinstance(ours, types.ModuleType)
                and "__getattr__" in vars(ours)):
            for attr in _defined_in(ref):
                if attr not in vars(ours):
                    _assert_stub_names_an_item(
                        lambda attr=attr: getattr(ours, attr))


@pytest.mark.parametrize("module", SHIPPED_MODULES)
def test_shipped_module_public_names_resolve(module):
    """Each public name a shipped reference module defines, in the port's
    module of the same path."""
    ref_mod = importlib.import_module("raft_tpu" + module)
    port_mod = importlib.import_module("raft_tpu_torch" + module)
    names = _public(module)
    assert names
    for name in names:
        _assert_counterpart(getattr(ref_mod, name), port_mod, name,
                            "raft_tpu_torch" + module)


def test_refine_and_select_k_are_the_functions():
    """As in the reference, the package attribute is the function, which
    shadows the submodule of the same name."""
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.neighbors import refine
    from raft_tpu_torch.matrix.select_k import select_k as select_k_fn
    from raft_tpu_torch.neighbors.refine import refine as refine_fn

    assert refine is refine_fn and select_k is select_k_fn
    assert callable(refine) and callable(select_k)


FRESH = {
    "packages": """
import raft_tpu_torch
from raft_tpu_torch.distance import DistanceType, fused_l2_nn, \\
    pairwise_distance
from raft_tpu_torch.cluster import KMeansParams
from raft_tpu_torch.neighbors import ivf_pq, refine
from raft_tpu_torch.matrix import select_k
raft_tpu_torch.RaftError, raft_tpu_torch.config
raft_tpu_torch.integrity.check_matrix
assert callable(refine) and callable(select_k)
assert ivf_pq.search
from raft_tpu_torch.filters import SampleFilter, TenantFilter, hybrid
from raft_tpu_torch.neighbors import mutate
assert SampleFilter.all_rows(5).words.shape == (1, 1) and mutate.tombstone
""",
    # a kernel wrapper first: its `from raft_tpu_torch.neighbors import
    # grouped` runs the package __init__ before the wrapper is complete
    "persistence": """
from raft_tpu_torch.resilience import CheckpointManager, inject
from raft_tpu_torch.core.serialize import CorruptIndexError
from raft_tpu_torch.integrity import canary
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch import auto_convert_output, config
assert ivf_pq.save and ivf_flat.load and cagra.deserialize
""",
    # the host-side subsystems: the observability package first, then the
    # index modules that import it
    "host-side": """
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import logger, tracing
from raft_tpu_torch.integrity import verify
from raft_tpu_torch.neighbors import delta, ivf_pq
assert obs.stage and obs.flight.dump and verify and delta.Memtable
assert logger.Logger.get() and tracing.range and ivf_pq.build
""",
    "ops-first": """
import raft_tpu_torch.ops.pq_group_scan
import raft_tpu_torch.ops.pq_code_scan
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, refine
assert callable(refine)
""",
}


@pytest.mark.parametrize("order", sorted(FRESH))
def test_fresh_interpreter_imports_without_jax(order):
    """In a new interpreter the port's package-level imports succeed,
    close no import cycle and load neither jax nor raft_tpu."""
    code = FRESH[order] + """
import sys
bad = [m for m in sys.modules
       if m in ("jax", "raft_tpu") or m.startswith(("jax.", "raft_tpu."))]
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_fail_raises_what_the_reference_raises():
    with pytest.raises(jax_error.LogicError) as ref:
        jax_error.fail("no such index")
    with pytest.raises(error.LogicError) as ours:
        error.fail("no such index")
    assert str(ours.value) == str(ref.value)
    assert isinstance(ours.value, error.RaftError)


def test_resources_registry_matches_the_reference():
    """Factories are called at the first get and their result kept; a
    copy shares the factories, not the resources; an unknown slot raises
    LogicError with the reference's message."""
    for mod in (jax_resources, resources):
        res = mod.Resources()
        calls = []
        res.add_resource_factory("x", lambda: calls.append(1) or len(calls))
        assert res.has_resource_factory("x")
        assert res.get_resource("x") == 1 and res.get_resource("x") == 1
        assert mod.Resources(res).get_resource("x") == 2
    with pytest.raises(jax_error.LogicError) as ref:
        jax_resources.Resources().get_resource("nope")
    with pytest.raises(error.LogicError) as ours:
        resources.Resources().get_resource("nope")
    assert str(ours.value) == str(ref.value)
    handle = resources.DeviceResources(seed=3, device="cpu")
    assert isinstance(handle, resources.Resources)
    assert handle.get_resource(resources.resource_type.DEVICE) == \
        torch.device("cpu")
    assert handle.get_resource(resources.resource_type.RNG) is \
        handle.generator
    assert {k: v for k, v in vars(resources.resource_type).items()
            if not k.startswith("_")} == {
        k: v for k, v in vars(jax_resources.resource_type).items()
        if not k.startswith("_")}


def _errors(fn_ref, fn_port):
    """The two calls' LogicError messages (None where one passes)."""
    out = []
    for fn, exc in ((fn_ref, jax_error.LogicError),
                    (fn_port, error.LogicError)):
        try:
            fn()
            out.append(None)
        except exc as e:
            out.append(str(e))
    return out


CHECKS = {
    "matrix ok": ("check_matrix", ((2, 3), "float32"), {}),
    "matrix rank": ("check_matrix", ((6,), "float32"), {}),
    "matrix dtype": ("check_matrix", ((2, 3), "float32"),
                     {"dtype": np.int32}),
    "matrix dtype name ok": ("check_matrix", ((2, 3), "int32"),
                          {"dtype": "int32"}),
    "matrix rows": ("check_matrix", ((2, 3), "float32"), {"rows": 4}),
    "matrix cols": ("check_matrix", ((2, 3), "float32"), {"cols": 4,
                                                          "name": "x"}),
    "vector ok": ("check_vector", ((5,), "int32"), {"size": 5}),
    "vector rank": ("check_vector", ((5, 1), "int32"), {}),
    "vector size": ("check_vector", ((5,), "int32"), {"size": 4}),
    "vector dtype": ("check_vector", ((5,), "int32"),
                     {"dtype": np.float32}),
    "rank": ("check_rank", ((2, 2, 2), "float32"), {"rank": 2}),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_checks_raise_what_the_reference_raises(case):
    """The check_* family on the same good and bad inputs: both pass, or
    both raise LogicError with the same message."""
    fn, (shape, dtype), kw = CHECKS[case]
    a = np.zeros(shape, dtype)
    ref, ours = _errors(
        lambda: getattr(jax_mdarray, fn)(jnp.asarray(a), **kw),
        lambda: getattr(mdarray, fn)(torch.from_numpy(a), **kw))
    assert ours == ref
    assert (ref is None) == case.endswith("ok")


def test_same_shape_and_dtype_checks_raise_what_the_reference_raises():
    a, b = np.zeros((2, 3), np.float32), np.zeros((3, 2), np.int32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for ref, ours in (
            (lambda: jax_mdarray.check_same_shape(ja, jb, ("x", "y")),
             lambda: mdarray.check_same_shape(ta, tb, ("x", "y"))),
            (lambda: jax_mdarray.check_same_dtype(ja, jb, ja),
             lambda: mdarray.check_same_dtype(ta, tb, ta)),
            (lambda: jax_mdarray.check_same_shape(ja, ja),
             lambda: mdarray.check_same_shape(ta, ta)),
            (lambda: jax_mdarray.check_same_dtype(ja, ja),
             lambda: mdarray.check_same_dtype(ta, ta))):
        assert _errors(ref, ours)[0] == _errors(ref, ours)[1]
    assert _errors(lambda: jax_mdarray.check_same_dtype(ja, jb),
                   lambda: mdarray.check_same_dtype(ta, tb))[0]


@pytest.mark.parametrize("fn,args", [
    ("make_device_matrix", (3, 4)), ("make_device_vector", (5,)),
    ("make_device_scalar", (2.5,))])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_factories_match_the_reference(fn, args, dtype):
    from raft_tpu import DeviceResources as JaxResources
    ref = getattr(jax_mdarray, fn)(JaxResources(), *args, dtype=dtype)
    ours = getattr(mdarray, fn)(resources.DeviceResources(device="cpu"),
                                *args, dtype=dtype)
    assert ours.device == torch.device("cpu")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert str(ours.dtype) == f"torch.{np.asarray(ref).dtype}"
    assert mdarray.row_major == jax_mdarray.row_major
    assert mdarray.col_major == jax_mdarray.col_major


def test_precision_trio_maps_onto_torch_and_raises_what_the_reference_does():
    """An unknown name raises KeyError in both, changing nothing; a known
    one sets torch's float32 matmul precision (TF32 on at "high"), and
    the context restores the previous setting."""
    with pytest.raises(KeyError):
        jax_precision.set_matmul_precision("fastest")
    with pytest.raises(KeyError):
        precision.set_matmul_precision("fastest")
    with pytest.raises(KeyError):
        with jax_precision.matmul_precision("fastest"):
            pass
    with pytest.raises(KeyError):
        with precision.matmul_precision("fastest"):
            pass
    assert precision.get_matmul_precision() == "highest"
    try:
        with precision.matmul_precision("high"):
            assert precision.get_matmul_precision() == "high"
            assert torch.backends.cuda.matmul.allow_tf32
            with precision.matmul_precision("bfloat16"):
                assert precision.get_matmul_precision() == "medium"
            assert precision.get_matmul_precision() == "high"
        assert precision.get_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
        precision.set_matmul_precision("float32")
        assert precision.get_matmul_precision() == "highest"
    finally:
        precision.set_matmul_precision("highest")

"""The port stands alone: `src/repro_torch` imports neither `jax` nor the
reference package `repro`, device backends never carry on quietly on the
CPU, and routes not ported yet raise NotImplementedError."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    """AST scan of every module under src/repro_torch."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(SRC)), root) for f in files
           for root in _imported_roots(f) if root in ("jax", "repro")]
    assert bad == []


def test_port_runs_q5_without_jax_or_reference_in_process():
    """A fresh interpreter runs Q5 through the port on the CPU and ends
    with neither `jax` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.tpch import generate, build_query\n"
        "from repro_torch.core.transfer import make_strategy\n"
        "from repro_torch.relational import ExecConfig, Executor\n"
        "cat = generate(sf=0.002, seed=3)\n"
        "cfg = ExecConfig(strategy=make_strategy('pred-trans', "
        "backend='cuda', device_resident=True, device='cpu'), "
        "join_backend='cuda', device='on', torch_device='cpu')\n"
        "res, st = Executor(cat, cfg).execute(build_query(5, sf=0.002))\n"
        "assert st.report()['device']['fused_calls'] > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_port_serves_and_curates_without_jax_or_reference_in_process():
    """A fresh interpreter serves Q5 cold and warm through the port's
    `QueryServer` and runs a `CurationPipeline`, both on the CPU, and
    ends with neither `jax` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.tpch import generate, build_query\n"
        "from repro_torch.serve import QueryServer, ServeConfig\n"
        "from repro_torch.data import CurationPipeline, synthetic_corpus\n"
        "cat = generate(sf=0.002, seed=3)\n"
        "cfg = ServeConfig(strategy='pred-trans', torch_device='cpu')\n"
        "with QueryServer(cat, cfg) as srv:\n"
        "    srv.query(build_query(5, sf=0.002))\n"
        "    _, st = srv.query(build_query(5, sf=0.002))\n"
        "assert st.transfer.from_cache\n"
        "pipe = CurationPipeline(synthetic_corpus(n_docs=300), device='cpu')\n"
        "assert len(pipe.select()) > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_backends_raise_without_cuda(no_cuda):
    """With no CUDA, every device entry point that was not asked for the
    CPU raises RuntimeError instead of running on the CPU."""
    from repro_torch.core.engine_bloom import get_engine
    from repro_torch.core.engine_join import get_join_engine
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_join_engine("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_strategy("pred-trans", backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor({}, ExecConfig(join_backend="cuda", device="on"))
    # the numpy backend ignores the device
    assert get_engine("numpy").backend == "numpy"
    assert get_join_engine("numpy", device="cuda").backend == "numpy"


def test_unported_routes_raise_not_implemented():
    """The distributed runtime is not ported; the plane-off route of the
    cuda backends is, so its engines now construct."""
    from repro_torch.core.engine_bloom import CudaEngine
    from repro_torch.core.engine_join import CudaJoinEngine
    from repro_torch.relational import ExecConfig, Executor
    assert not CudaEngine(device_resident=False, device="cpu").device_resident
    assert not CudaJoinEngine(device_resident=False,
                              device="cpu").device_resident
    with pytest.raises(NotImplementedError, match="distributed"):
        Executor({}, ExecConfig(engine="distributed"))


def _q5_config(backend, **kw):
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig
    return ExecConfig(strategy=make_strategy(
        "pred-trans", backend=backend, device_resident=True, device="cpu"),
        join_backend=backend, device="on", torch_device="cpu", **kw)


@pytest.mark.parametrize("wrapper", ["multi_probe", "build"])
def test_degrade_never_moves_a_cuda_rung_to_the_host(monkeypatch, wrapper):
    """With the ladder armed, a kernel wrapper that fails (as a failed
    nvcc build or launch does) makes the query raise; no numpy-rung
    result comes back in its place."""
    from repro_torch.kernels.bloom import ops as kb
    from repro_torch.relational import Executor
    from repro_torch.tpch import build_query, generate

    def broken(*a, **kw):
        raise RuntimeError("bloom kernel failed to launch")

    monkeypatch.setattr(kb, wrapper, broken)
    cat = generate(sf=0.002, seed=3)
    with pytest.raises(RuntimeError, match="failed to launch"):
        Executor(cat, _q5_config("cuda", degrade=True)).execute(
            build_query(5, sf=0.002))


def test_degrade_still_steps_host_rungs():
    """On the numpy backends the ladder keeps its moves: an injected
    probe fault steps pred-trans down to no-pred-trans, with the same
    result as the undisturbed run."""
    from repro_torch.core import faultinject
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import build_query, generate
    cat = generate(sf=0.002, seed=3)
    want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.002))
    cfg = ExecConfig(strategy=_q5_config("numpy").strategy, degrade=True)
    with faultinject.inject({"engine.probe": "all"}):
        got, st = Executor(cat, cfg).execute(build_query(5, sf=0.002))
    assert [d["to"] for d in st.degraded] == [
        "single/late/numpy+no-pred-trans"]
    assert table_digest(got) == table_digest(want)


def test_port_serves_lm_without_jax_or_reference_in_process():
    """A fresh interpreter runs the serving launcher on the CPU (smoke
    config) and ends with neither `jax` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--config', 'smoke', '--device', 'cpu', "
        "'--batch', '2', '--prompt-len', '16', '--gen-tokens', '3']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert "generated shape (2, 4)" in out.stdout


def test_port_serves_mla_moe_without_jax_or_reference_in_process():
    """A fresh interpreter serves deepseek-v2-lite's smoke config (MLA,
    the routed MoE, a dense first layer) through the launcher on the CPU
    and ends with neither `jax` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--arch', 'deepseek-v2-lite-16b', '--config', "
        "'smoke', '--device', 'cpu', '--batch', '2', '--prompt-len', '16', "
        "'--gen-tokens', '3']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert "deepseek-v2-lite-smoke" in out.stdout
    assert "generated shape (2, 4)" in out.stdout


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m"])
def test_unported_archs_raise_not_implemented(arch):
    """Sliding-window attention (mixtral) and Mamba-2 models are not
    ported yet: building one, or serving one, raises NotImplementedError
    naming its ROADMAP item."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    for cfg in (get_config(arch), get_smoke_config(arch)):
        with pytest.raises(NotImplementedError, match="item 10c"):
            Model(cfg)
    with pytest.raises(NotImplementedError, match="item 10c"):
        serve.main(["--arch", arch, "--config", "smoke", "--device", "cpu"])


def test_serve_on_cuda_without_cuda_raises(no_cuda):
    """`--device cuda` (the default) with no CUDA raises instead of
    running on the CPU."""
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--config", "smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--config", "smoke", "--device", "cuda:0"])


def test_unknown_backend_and_device_rejected():
    from repro_torch.core.engine_bloom import get_engine
    from repro_torch.core.transfer import make_strategy
    with pytest.raises(ValueError):
        get_engine("pallas")
    with pytest.raises(ValueError):
        get_engine("cuda", device="meta")
    with pytest.raises(ValueError):
        make_strategy("yannakakis", backend="numpy")
    with pytest.raises(ValueError):
        make_strategy("no-pred-trans", device="cpu")

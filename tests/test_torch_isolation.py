"""The port stands alone: `src/repro_torch` imports neither `jax` nor the
reference package `repro`, device backends never carry on quietly on the
CPU, and routes not ported yet raise NotImplementedError; every
architecture of the zoo is ported."""
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
    """AST scan of every module under src/repro_torch, the training path
    (train/, checkpoint/, ft/, launch/train.py) included: no jax, no
    ml_dtypes, no reference package."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    names = {str(f.relative_to(PORT)) for f in files}
    for need in ("train/optim.py", "train/step.py", "train/tree.py",
                 "checkpoint/manager.py", "ft/runner.py",
                 "launch/train.py", "parallel/compress.py",
                 "launch/analytic.py", "launch/specs.py",
                 "launch/dryrun.py", "launch/roofline.py",
                 "launch/collectives.py", "launch/mesh.py",
                 "parallel/hints.py",
                 "parallel/sharding.py", "parallel/spmd.py"):
        assert need in names, need
    bad = [(str(f.relative_to(SRC)), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "repro", "ml_dtypes")]
    assert bad == []


def test_port_runs_q5_without_jax_or_reference_in_process():
    """A fresh interpreter runs Q5 through the port on the CPU, on one
    host and through the distributed runtime (4 shards of a CPU mesh),
    and ends with neither `jax` nor `repro` loaded."""
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
        "from repro_torch.core.engine_join_dist import "
        "DistributedJoinEngine\n"
        "from repro_torch.launch.mesh import make_data_mesh\n"
        "from repro_torch.relational.table import table_digest\n"
        "d, dst = Executor(cat, cfg.replace(engine='distributed', "
        "dist_shards=4)).execute(build_query(5, sf=0.002))\n"
        "assert table_digest(d) == table_digest(res)\n"
        "assert dst.report()['dist']['nshards'] == 4\n"
        "eng = DistributedJoinEngine(mesh=make_data_mesh(4, devices=['cpu'] "
        "* 4), local_backend='cuda', torch_device='cpu')\n"
        "assert eng.exchange.device_backed\n"
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
    for backend in ("torch", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_engine(backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_join_engine(backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_strategy("pred-trans", backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            Executor({}, ExecConfig(join_backend=backend, device="on"))
        with pytest.raises(RuntimeError, match="CUDA"):
            Executor({}, ExecConfig(join_backend=backend,
                                    engine="distributed", dist_shards=4))
    # the numpy backend ignores the device
    assert get_engine("numpy").backend == "numpy"
    assert get_join_engine("numpy", device="cuda").backend == "numpy"


def test_unported_routes_raise_not_implemented():
    """Routes that once raised here now construct and run: the plane-off
    route of the cuda backends, the distributed runtime (on the numpy
    backends and on the cuda and torch backends on the CPU), the torch
    backends on both planes, the MoE auxiliary loss and `Model.loss`."""
    from repro_torch.core.engine_bloom import CudaEngine
    from repro_torch.core.engine_join import CudaJoinEngine
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import build_query, generate
    assert not CudaEngine(device_resident=False, device="cpu").device_resident
    assert not CudaJoinEngine(device_resident=False,
                              device="cpu").device_resident
    cat = generate(sf=0.002, seed=3)
    want, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
        build_query(5, sf=0.002))
    for kw in ({}, {"join_backend": "cuda", "torch_device": "cpu"},
               {"join_backend": "torch", "torch_device": "cpu"}):
        ex = Executor(cat, ExecConfig(engine="distributed", **kw))
        assert ex.join_engine.backend == "distributed"
        got, st = ex.execute(build_query(5, sf=0.002))
        assert table_digest(got) == table_digest(want)
        assert st.report()["dist"]["nshards"] == 4
    from repro_torch.core.transfer import make_strategy
    for plane in ("on", "off"):
        cfg = ExecConfig(strategy=make_strategy(
            "pred-trans", backend="torch", device_resident=plane == "on",
            device="cpu"), join_backend="torch", device=plane,
            torch_device="cpu")
        got, _ = Executor(cat, cfg).execute(build_query(5, sf=0.002))
        assert table_digest(got) == table_digest(want)
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import Batch, Model
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"),
                              dtype=torch.float32)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    moe = params["layers"][0]["ffn"]
    aux = L.moe_aux_loss({k: v[0] for k, v in moe.items()
                          if not isinstance(v, dict)}, x, cfg)
    assert aux.ndim == 0 and 0.0 < float(aux) < cfg.moe.num_experts
    tok = torch.randint(0, cfg.vocab_size, (2, 8))
    with L.attention_backend("auto"):
        assert torch.isfinite(m.loss(params, Batch(tok, tok)))


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


def test_port_serves_swa_and_ssm_without_jax_or_reference_in_process():
    """A fresh interpreter serves the sliding-window (mixtral), Mamba-2
    (mamba2-370m) and hybrid (jamba) smoke configs through the launcher
    on the CPU and ends with neither `jax` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('mixtral-8x7b', 'mamba2-370m', "
        "'jamba-1.5-large-398b'):\n"
        "    assert serve.main(['--arch', arch, '--config', 'smoke', "
        "'--device', 'cpu', '--batch', '2', '--prompt-len', '40', "
        "'--gen-tokens', '3']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    for name in ("mixtral-8x7b-smoke", "mamba2-370m-smoke", "jamba-smoke"):
        assert name in out.stdout
    assert out.stdout.count("generated shape (2, 4)") == 3


def test_port_trains_without_jax_or_reference_in_process(tmp_path):
    """A fresh interpreter runs the training launcher on the CPU (smoke
    config, checkpoints under a temp directory), resumes from its
    checkpoint, and ends with neither `jax`, `ml_dtypes` nor `repro`
    loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        f"args = ['--arch', 'qwen1.5-4b', '--device', 'cpu', '--steps', "
        f"'3', '--batch', '2', '--seq', '16', '--ckpt-dir', "
        f"{str(tmp_path)!r}]\n"
        "assert train.main(args) == 0\n"
        "assert train.main(args[:5] + ['5'] + args[6:]) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert "finished at step 3" in out.stdout
    assert "finished at step 5" in out.stdout


def test_launch_reports_without_jax_or_reference_in_process(tmp_path):
    """A fresh interpreter writes the dry-run report of two cells on both
    production meshes (the FLOP trace on the meta device) and the
    roofline over them, under a temp directory, and ends with neither
    `jax`, `ml_dtypes` nor `repro` loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun, roofline\n"
        f"root = {str(tmp_path)!r}\n"
        "for shape in ('decode_32k', 'long_500k'):\n"
        "    assert dryrun.main(['--arch', 'mamba2-370m', '--shape', shape,"
        " '--reports', root]) == 0\n"
        "assert roofline.main(['--mesh', 'multi', '--reports', root]) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert len(list((tmp_path / "dryrun").glob("*.json"))) == 4
    assert (tmp_path / "roofline_multi.md").exists()


def test_train_on_cuda_without_cuda_raises(no_cuda):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen1.5-4b", "--steps", "1"])


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_encdec_and_vlm_archs_serve_and_train(arch, tmp_path, capsys):
    """The encoder-decoder (whisper: the encoder and cross-attention) and
    the stub-frontend (llava: the patch prefix) models are ported: both
    configs build, the launcher serves the smoke config on the CPU, and
    the training launcher takes two steps of it, with the stub
    frontend's embeddings in every batch."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models.model import Model
    for cfg in (get_config(arch), get_smoke_config(arch)):
        assert Model(cfg).cfg is cfg
    assert serve.main(["--arch", arch, "--config", "smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16",
                       "--gen-tokens", "3"]) == 0
    assert train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert get_smoke_config(arch).name in out
    assert "generated shape (2, 4)" in out
    assert "finished at step 2" in out


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

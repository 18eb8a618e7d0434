"""Rules of the port's package: it imports nothing of JAX or of the JAX
package, asks for the card unless told otherwise and raises rather than
fall back, and keeps its own copies of the JAX package's jax-free pieces in
step with the originals."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orion_tpu.models import configs as jax_configs
from orion_tpu.utils import config as jax_config_utils
from orion_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from orion_tpu_torch.models import configs
from orion_tpu_torch.utils import config as config_utils
from orion_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "orion_tpu_torch"
_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "orion_tpu")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_every_module_imports_with_jax_and_orion_tpu_blocked():
    code = (
        "import importlib, sys\n"
        f"for name in {_BANNED!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_the_scans_cover_the_serving_slice():
    """The import block and the AST scan below walk every module of the
    package, the serving slice's ``serving/``, ``obs/`` and ``resilience/``
    among them (the Server, its CLI and the host modules it builds)."""
    assert {"orion_tpu_torch.serving", "orion_tpu_torch.serving.session",
            "orion_tpu_torch.serving.batching", "orion_tpu_torch.serving.server",
            "orion_tpu_torch.serving.health", "orion_tpu_torch.serving.locks",
            "orion_tpu_torch.serving.__main__", "orion_tpu_torch.obs.flight",
            "orion_tpu_torch.obs.metrics", "orion_tpu_torch.obs.trace",
            "orion_tpu_torch.resilience.inject", "orion_tpu_torch.resilience.preempt",
            "orion_tpu_torch.resilience.watchdog"} <= set(_modules())


@pytest.mark.parametrize(
    "path",
    [*sorted(PKG.rglob("*.py")), *(ROOT / f for f in ("chip_smoke.py", "profile_port.py",
                                                 "kernel_mutants.py", "time_decode.py",
                                                 "time_op.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_of_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _BANNED, f"{path}: imports {name}"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


def test_only_the_export_script_imports_both_packages():
    """The repo-root scripts that use the port import nothing of JAX, but
    ``export_jax_checkpoint.py``, which turns a JAX package checkpoint into
    one of the port's."""
    both = sorted(p.name for p in ROOT.glob("*.py")
                  if "orion_tpu_torch" in _imports(p) and _imports(p) & set(_BANNED))
    assert both == ["export_jax_checkpoint.py"]


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from orion_tpu_torch.models.transformer import TransformerLM, init_decode_state
    from orion_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(configs.TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(configs.TINY, 1, device="cuda")
    from orion_tpu_torch.generate import main

    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--max-new-tokens", "1"])


def test_backend_cuda_on_cpu_tensors_raises():
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.ops.kernels import causal_dot

    q = torch.rand(2, 5, 4)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot.causal_dot_norm_cuda(q, q, q)
    model = TransformerLM(dataclasses.replace(configs.TINY, backend="cuda"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        model.prefill_last(torch.zeros(1, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="s0"):
        causal_dot.causal_dot_norm_plain(q, q, q, torch.zeros(2, 4, 4), None)


def test_model_config_mirrors_the_jax_package():
    ours = {f.name: f.default for f in dataclasses.fields(configs.ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_configs.ModelConfig)}
    assert ours == theirs
    assert configs.CONFIGS.keys() == jax_configs.CONFIGS.keys()
    for name, cfg in configs.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_configs.CONFIGS[name]), name
        ref = jax_configs.CONFIGS[name]
        assert cfg.resolved_head_dim == ref.resolved_head_dim
        assert cfg.resolved_mlp_hidden == ref.resolved_mlp_hidden
    with pytest.raises(ValueError, match="unknown config"):
        configs.get_config("nope")


def test_train_config_mirrors_the_jax_package():
    from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
    from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig

    for ours, theirs in ((TrainConfig, JaxTrainConfig), (MeshConfig, JaxMeshConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs()), ours.__name__
    pairs = ["lr=1e-3", "model.n_layers=3", "mesh.tp=2", "mu_dtype=bfloat16"]
    ours = config_utils.apply_overrides(TrainConfig(), config_utils.parse_set_overrides(pairs))
    theirs = jax_config_utils.apply_overrides(
        JaxTrainConfig(), jax_config_utils.parse_set_overrides(pairs))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_json_overrides_mirror_the_jax_package(tmp_path):
    from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
    from orion_tpu_torch.training.trainer import TrainConfig

    path = tmp_path / "o.json"
    path.write_text('{"lr": 0.001, "model": {"n_layers": 3, "dtype": "float32"}, "mesh.sp": 1}')
    ours = config_utils.apply_overrides(TrainConfig(), config_utils.load_json_overrides(str(path)))
    theirs = jax_config_utils.apply_overrides(
        JaxTrainConfig(), jax_config_utils.load_json_overrides(str(path)))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.lr == 0.001 and ours.model.n_layers == 3


def test_set_overrides_mirror_the_jax_package():
    pairs = ["n_layers=3", "dtype=float32", "tie_embeddings=false", "moe_aux_weight=0.5"]
    ours = config_utils.apply_overrides(configs.TINY, config_utils.parse_set_overrides(pairs))
    theirs = jax_config_utils.apply_overrides(
        jax_configs.TINY, jax_config_utils.parse_set_overrides(pairs)
    )
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    with pytest.raises(KeyError):
        config_utils.apply_overrides(configs.TINY, {"nope": 1})
    with pytest.raises(ValueError):
        config_utils.parse_set_overrides(["novalue"])


def test_byte_tokenizer_mirrors_the_jax_package():
    text = "héllo, wörld ☃"
    for specials in (False, True):
        ours, theirs = ByteTokenizer(specials), JaxByteTokenizer(specials)
        assert ours.encode(text) == theirs.encode(text)
        assert ours.vocab_size == theirs.vocab_size
        ids = ours.encode(text) + [300, 257]
        assert ours.decode(ids) == theirs.decode(ids)

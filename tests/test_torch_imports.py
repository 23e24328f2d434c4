"""The port stands alone: it imports neither JAX, nor Triton, nor anything
of the JAX package, nor ``torch.testing._internal``, and its entry points
never drift to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .replace(".__init__", "")
    for p in PORT.rglob("*.py"))


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_every_module_loads_no_jax_and_no_repro():
    assert {"repro_torch.core.prng", "repro_torch.launch.serve",
            "repro_torch.models.encdec", "repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.whisper_small",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.serving.paged_cache",
            "repro_torch.distribution", "repro_torch.distribution.sharding",
            "repro_torch.launch.mesh",
            "repro_torch.serving.sampling_distributed",
            "repro_torch.launch.flops", "repro_torch.launch.collective_cost",
            "repro_torch.launch.dryrun"} <= set(MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'triton' or m == 'repro' or"
        " m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(MODULES)


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")),
                                  ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_triton_or_repro(path):
    """Statically, including imports inside functions."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "triton", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"
            assert not name.startswith("torch.testing._internal"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    m = build_model(reduced(get_config("llama2-110m")))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [1.0]})
    params = m.quantize(m.init(0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(m, params, max_slots=1, max_seq=16, page_size=8)
    # a mesh needs the paged pool, as in the reference
    with pytest.raises(ValueError, match="paged cache"):
        Engine(m, params, max_slots=1, max_seq=16, page_size=8,
               cache_kind="dense", mesh=object(), device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(requests=1)
    from repro_torch.models.transformer import prefill_fused_mode
    from repro_torch.serving.paged_cache import (PagedConfig, PagedKVCache,
                                                 init_pool)
    pcfg = PagedConfig(n_layers=1, n_kv_heads=1, head_dim=4)
    for make in (lambda: init_pool(pcfg), lambda: PagedKVCache(pcfg),
                 prefill_fused_mode):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    for arch in ("qwen2-vl-7b", "whisper-small",
                 "llama4-maverick-400b-a17b"):
        other = build_model(reduced(get_config(arch)))
        with pytest.raises(RuntimeError, match="CUDA"):
            other.init(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            other.init_quantized(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            other.init_cache(1, 16)
    eng = Engine(m, params, max_slots=2, max_seq=16, page_size=8,
                 device="cpu")
    assert eng.step_async() == (None, None)          # idle
    eng.submit([5, 6, 7], max_new_tokens=3, temperature=0.0)
    pending = None
    while pending is None and eng.scheduler.has_work():
        _, pending = eng.step_async()
    assert pending is not None
    eng.finish_step(pending)
    assert eng.finish_step() == [] and eng._pending is None
    eng.run()
    # sampled requests and best-of-n groups are served now
    eng.submit([5, 6, 7], max_new_tokens=2)          # temperature 1.0
    eng.submit([5, 6, 7], max_new_tokens=2, temperature=0.7, top_p=0.9,
               n_samples=2)
    done = eng.run()
    assert [r.error for r in done] == [None, None]
    assert [len(r.outputs) for r in done] == [1, 2]


def test_check_family_takes_vlm_audio_and_the_interleave():
    """Every config of the JAX package builds in the port, the vlm and
    audio families and llama4's interleave (``moe_every`` 2) among them;
    the port's config registry holds every one of the JAX package's."""
    from repro_torch.configs import ModelConfig, get_config, reduced
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import check_family
    for arch in ("qwen2-vl-7b", "whisper-small",
                 "llama4-maverick-400b-a17b"):
        for cfg in (get_config(arch), reduced(get_config(arch))):
            check_family(cfg)
            assert build_model(cfg).cfg.family in ("vlm", "audio", "moe")
    llama4 = ModelConfig(arch_id="llama4-like", family="moe", n_layers=4,
                         d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                         vocab_size=512, n_experts=8, top_k=1, moe_every=2)
    check_family(llama4)
    assert not build_model(llama4).supports_paged_cache
    jax_configs = {p.stem for p in (ROOT / "src" / "repro" / "configs")
                   .glob("*.py") if p.stem not in ("__init__", "base")}
    port_configs = {p.stem for p in (PORT / "configs").glob("*.py")
                    if p.stem not in ("__init__", "base")}
    assert jax_configs == port_configs
    # a family's blocks are its own: no LayerNorm decoder-only model, no
    # SwiGLU encoder-decoder
    for cfg in (reduced(get_config("llama2-110m")).with_(
                    norm_type="layernorm"),
                reduced(get_config("whisper-small")).with_(
                    mlp_type="swiglu")):
        with pytest.raises(NotImplementedError, match="ported"):
            check_family(cfg)


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""

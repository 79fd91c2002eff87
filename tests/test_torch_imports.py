"""The port stands alone: no file under seld_tpu_torch/, and not
chip_smoke.py, imports jax, flax or seld_tpu; the modules it copies stay
equal to their originals; chip_smoke.py refuses to run without a card.
"""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "seld_tpu_torch", "**",
                                           "*.py"), recursive=True))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "seld_tpu")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_files_exist():
    names = {os.path.relpath(p, REPO) for p in PORT_FILES}
    for want in ("config/registry.py", "config/zoo.py", "models/layers.py",
                 "models/modules.py", "models/models.py", "ops/gru.py",
                 "inference/export.py", "serving/server.py",
                 "serving/client.py", "bridge.py", "ops/stem.py",
                 "ops/stem_bwd.py", "train/losses.py", "train/metrics.py",
                 "train/optimizers.py", "train/steps.py",
                 "train/train_state.py", "nas/complexity.py", "bench.py",
                 "profile_step.py", "utils/coords.py", "ops/stft.py",
                 "ops/mel.py", "ops/frontend.py", "ops/features.py",
                 "ops/gather.py", "data/loader.py", "data/wav_pipeline.py",
                 "data/device_dataset.py", "data/transforms.py",
                 "train/checkpoint.py", "utils/logging.py",
                 "config/params.py", "config/manager.py",
                 "train/trainer.py", "train/main.py", "train/__main__.py",
                 "utils/io.py", "train/official_metrics.py",
                 "inference/ensemble.py", "inference/quantize.py",
                 "make_answer.py", "search_best.py", "bench_infer.py",
                 "dress_rehearsal.py", "inference/streaming.py",
                 "inference/streaming_wav.py", "stream_demo.py",
                 "predict_wav.py", "data/tdm.py", "data/tdm_pipeline.py",
                 "nas/sampler.py", "nas/analyzer.py", "nas/plots.py",
                 "nas/search.py", "data/vad.py", "train/vad.py",
                 "nas_search.py", "analyze_nas.py", "train_vad.py",
                 "prepare_vad.py", "vad_rehearsal.py", "parallel/mesh.py",
                 "parallel/collectives.py", "parallel/partitioning.py",
                 "compat/keras_h5.py", "import_tf_weights.py",
                 "utils/profiling.py", "utils/trace_analysis.py",
                 "profile_train.py", "extract_features.py",
                 "bench_frontend.py", "smoke.py"):
        assert os.path.join("seld_tpu_torch", want) in names


@pytest.mark.parametrize("path", PORT_FILES + [
    os.path.join(REPO, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_copied_zoo_and_client_are_byte_identical():
    for rel in ("config/zoo.py", "serving/client.py"):
        with open(os.path.join(REPO, "seld_tpu", rel)) as f:
            want = f.read()
        with open(os.path.join(REPO, "seld_tpu_torch", rel)) as f:
            assert f.read() == want, rel


def test_model_configs_equal():
    from seld_tpu.config.zoo import MODEL_CONFIGS as want
    from seld_tpu_torch.config.zoo import MODEL_CONFIGS as got
    assert got == want


def test_rehearsal_tiny_config_equals_the_jax_rehearsal():
    """The port's dress rehearsal writes the JAX rehearsal's TINY_CONFIG
    (scripts/dress_rehearsal.py, read by its AST: the script configures
    JAX at import)."""
    from seld_tpu_torch.dress_rehearsal import TINY_CONFIG
    with open(os.path.join(REPO, "scripts", "dress_rehearsal.py")) as f:
        tree = ast.parse(f.read())
    want = [ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign)
            and [t.id for t in node.targets] == ["TINY_CONFIG"]]
    assert want == [TINY_CONFIG]


def _code_without_docstrings(path, package):
    with open(path) as f:
        tree = ast.parse(f.read().replace(package, "PKG"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
    return ast.dump(tree)


def test_registry_copy_equals_original_modulo_package():
    want = _code_without_docstrings(
        os.path.join(REPO, "seld_tpu", "config", "registry.py"), "seld_tpu.")
    got = _code_without_docstrings(
        os.path.join(REPO, "seld_tpu_torch", "config", "registry.py"),
        "seld_tpu_torch.")
    assert got == want


@pytest.mark.parametrize("rel", ["config/params.py", "config/manager.py",
                                 "utils/coords.py", "utils/logging.py",
                                 "utils/io.py", "train/official_metrics.py",
                                 "data/tdm.py", "nas/complexity.py",
                                 "nas/sampler.py", "nas/analyzer.py",
                                 "nas/plots.py"])
def test_copied_modules_equal_originals_modulo_package(rel):
    """The flag table and config store, the coordinate helpers, the scalar
    logger, the DCASE CSV I/O, the official scorer, TDM's event banks
    and paste, and the NAS complexity table, samplers, result analysis and
    plots are copies: code equal to the JAX package's."""
    want = _code_without_docstrings(os.path.join(REPO, "seld_tpu", rel),
                                    "seld_tpu.")
    got = _code_without_docstrings(os.path.join(REPO, "seld_tpu_torch", rel),
                                   "seld_tpu_torch.")
    assert got == want


def _function_ast(path, name):
    """A top-level function's signature and body, its docstring and its
    `if n_devices is None:` default (which asks its own framework for the
    device count) left out."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    body = [st for st in fn.body[1:]
            if not (isinstance(st, ast.If) and "n_devices is None"
                    in ast.unparse(st.test))]
    return ast.dump(fn.args) + "".join(ast.dump(st) for st in body)


def test_parse_mesh_spec_copy_equals_original():
    """seld_tpu_torch/parallel/mesh.py::parse_mesh_spec is a copy of the
    JAX package's; only where `data:-1` counts the devices differs (the
    group's ranks or the visible cards, `visible_devices`)."""
    rel = os.path.join("parallel", "mesh.py")
    assert _function_ast(os.path.join(REPO, "seld_tpu_torch", rel),
                         "parse_mesh_spec") == _function_ast(
        os.path.join(REPO, "seld_tpu", rel), "parse_mesh_spec")


def _top_level_ast(path, name):
    """A top-level class's or function's code, docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                and n.name == name)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            sub.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name", ["H5Layer", "read_legacy_h5", "_decode",
                                  "_is_init_ln"])
def test_keras_h5_parsing_copy_equals_original(name):
    """compat/keras_h5.py's parsing of the legacy file is a copy of the JAX
    package's: the same code, docstrings apart."""
    rel = os.path.join("compat", "keras_h5.py")
    assert _top_level_ast(os.path.join(REPO, "seld_tpu_torch", rel),
                          name) == _top_level_ast(
        os.path.join(REPO, "seld_tpu", rel), name)


def test_keras_h5_tables_equal():
    from seld_tpu.compat import keras_h5 as want
    from seld_tpu_torch.compat import keras_h5 as got
    assert got._BASE_KIND == want._BASE_KIND
    assert got._NAME_RE.pattern == want._NAME_RE.pattern
    # the port's module classes carry flax's names, kind for kind
    assert got.FLAX_KIND == want.FLAX_KIND


@pytest.mark.parametrize("xla,cuda", [
    ("%fusion.12 = f32[256,64]{1,0} fusion(f32[256,64]{1,0} %p0)",
     "void at::native::vectorized_elementwise_kernel<4, ...>"),
    ("%convolution.3 = bf16[256,60,32,32]{3,2,1,0} convolution(%a, %b)",
     "cudnn::engines_precompiled::conv2d_grouped_direct_kernel"),
    ("%dot.7 = f32[256,128]{1,0} dot(f32[256,64]{1,0} %a, %b)",
     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n")])
def test_trace_classes_correspond_to_the_jax_classes(xla, cuda):
    """utils/trace_analysis.py's `_classify` keeps the JAX package's
    classes where a torch trace can name them: XLA's fusions, convolutions
    and dots are the port's elementwise passes, convolutions and GEMMs."""
    from seld_tpu.utils.trace_analysis import _classify as want
    from seld_tpu_torch.utils.trace_analysis import _classify as got
    families = {"fusion": "elementwise", "convolution": "conv",
                "dot": "gemm"}
    assert got(cuda) == families[want(xla).split(":")[0]]


def test_copied_constants_equal():
    """The front-end's constants (mel filterbank, DFT bases, window) and
    the fold splits are the JAX package's values."""
    import numpy as np
    from seld_tpu.data.loader import SPLITS as want_splits
    from seld_tpu.ops.mel import _mel_filterbank_np as want_fb
    from seld_tpu.ops.stft import _dft_bases as want_dft
    from seld_tpu.ops.stft import _padded_window as want_window
    from seld_tpu_torch.data.loader import SPLITS
    from seld_tpu_torch.ops.mel import _mel_filterbank_np
    from seld_tpu_torch.ops.stft import _dft_bases, _padded_window_np
    assert SPLITS == want_splits
    for args in ((513, 64, 24000, 0.0, 12000.0), (257, 40, 16000, 0.0,
                                                  8000.0)):
        np.testing.assert_array_equal(_mel_filterbank_np(*args),
                                      want_fb(*args))
    for n_fft, win in ((1024, 960), (512, 512)):
        for got, want in zip(_dft_bases(n_fft), want_dft(n_fft)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_padded_window_np(n_fft, win),
                                      np.asarray(want_window(n_fft, win)))


def test_copied_channel_swap_tables_equal():
    """acs_aug's tables (the 8 array rotations and reflections, the GCC
    pair decoding) are the JAX package's values."""
    import numpy as np
    from seld_tpu.data import transforms as want
    from seld_tpu_torch.data import transforms as got
    for name in ("CHANNEL_LIST", "_GCC_DECODE", "_GCC_PAIRS"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype


def _device_defaults(path):
    """(where, default) of every `--device` flag and every parameter named
    `device` with a constant default in a file of the port."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "add_argument" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "--device":
            for kw in node.keywords:
                if kw.arg == "default":
                    yield f"--device at line {node.lineno}", ast.literal_eval(
                        kw.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            positional = args.posonlyargs + args.args
            pairs = list(zip(positional[len(positional)
                                        - len(args.defaults):],
                             args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults) if d]
            for arg, default in pairs:
                if arg.arg == "device" and isinstance(default, ast.Constant):
                    yield f"{node.name}(device=...)", default.value


def test_entry_points_default_to_the_card():
    """Every command-line entry point's --device defaults to cuda, and no
    function of the port defaults its device to the CPU: the CPU runs
    only when the caller asks for it (as the tests do)."""
    flags, bad = 0, []
    for path in PORT_FILES:
        for where, default in _device_defaults(path):
            flags += where.startswith("--device")
            if default not in ("cuda", None):
                bad.append(f"{os.path.relpath(path, REPO)}: {where} "
                           f"defaults to {default!r}")
    assert not bad, bad
    assert flags >= 9


def test_common_helpers_equal():
    from seld_tpu.utils import common as want
    from seld_tpu_torch import utils as got
    cfg = {f"BLOCK{i}": "x" for i in (0, 2, 10, 1)}
    cfg.update({"BLOCK10_ARGS": {}, "SED": "y"})
    assert got.sorted_block_keys(cfg) == want.sorted_block_keys(cfg) == [
        "BLOCK0", "BLOCK1", "BLOCK2", "BLOCK10"]
    for v in (3, 2.0, [4], (1, 2)):
        assert got.safe_tuple(v) == want.safe_tuple(v)
    for shape in ([7, 80, 1], [60, 32], [560]):
        assert got.force_1d_shape(shape) == want.force_1d_shape(shape)
    assert got.dict_add({"a": 1}, {"a": 2, "b": 3}) == \
        want.dict_add({"a": 1}, {"a": 2, "b": 3})
    with pytest.raises(ValueError):
        got.safe_tuple((1, 2, 3))


def test_chip_smoke_imports_no_matplotlib():
    """The card machine has no matplotlib: nothing that chip_smoke.py
    imports, nor the NAS and VAD entry points it drives, pulls it in
    (seld_tpu_torch.nas.plots is imported only under analyze_nas --plots).
    Checked in a fresh interpreter through sys.modules."""
    code = ("import sys, chip_smoke\n"
            "import seld_tpu_torch.nas, seld_tpu_torch.nas.search, "
            "seld_tpu_torch.nas.analyzer, seld_tpu_torch.nas_search, "
            "seld_tpu_torch.analyze_nas, seld_tpu_torch.train_vad, "
            "seld_tpu_torch.prepare_vad, seld_tpu_torch.vad_rehearsal, "
            "seld_tpu_torch.train.vad, seld_tpu_torch.data.vad\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'matplotlib' "
            "or m == 'seld_tpu_torch.nas.plots')\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the port builds nothing; the library name carries a hash
    of the source, so an edited source builds anew."""
    from seld_tpu_torch.ops import kernels
    assert not kernels._libs
    path = kernels.library_path("gru_fwd.cu")
    assert path.startswith(os.path.join(REPO, "build", "kernels"))
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for source, replaced in (
            ("gru_fwd.cu", "seld_tpu/ops/pallas/gru.py::_fwd_kernel"),
            ("gru_bwd.cu", "seld_tpu/ops/pallas/gru.py::_bwd_kernel"),
            ("stem_dy.cu", "seld_tpu/ops/pallas/stem_bwd.py::_dy_kernel"),
            ("foa_frontend.cu",
             "seld_tpu/ops/pallas/frontend.py::_frontend_kernel"),
            ("gather_rows.cu", "seld_tpu/ops/pallas/gather.py::_gather_lanes"),
            ("gather_rows.cu", "seld_tpu/ops/pallas/gather.py::_gather_dma")):
        assert source in kernels.SOURCES
        with open(os.path.join(kernels.CSRC_DIR, source)) as f:
            src = f.read()
        assert replaced in src and "seld_cuda_error_string" in src
    assert set(kernels.KERNELS.values()) == set(kernels.SOURCES)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

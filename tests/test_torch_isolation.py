"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX
package, nor any package the GPU machine lacks: every module is imported in a
fresh interpreter whose import system refuses ``jax``, ``flax``, ``optax`` and
``sliders_conceptmod_tpu`` (that exact top-level name, so
``sliders_conceptmod_tpu_torch`` itself still imports), and also ``yaml``,
``pydantic``, ``transformers``, ``tokenizers``, ``PIL``, ``safetensors``,
``regex``, ``pandas``, ``torchvision``, ``lpips`` and ``zstandard``. A lazy
import inside a function escapes that check, so the source of every port
module and of chip_smoke.py is also scanned for an import statement of a
refused package."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "flax", "optax", "sliders_conceptmod_tpu", "yaml", "pydantic", "transformers",
               "tokenizers", "PIL", "safetensors", "regex", "pandas", "torchvision", "lpips", "zstandard"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")

    sys.meta_path.insert(0, Refuse())
    import sliders_conceptmod_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print(len(names), "modules:", " ".join(names))
    """
)

# modules the SD slice added or extended: the SD CLI, the k-grid backward
# (K4b/K4c), the SD model configs and loaders
SD_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.cli.train_lora",
    "sliders_conceptmod_tpu_torch.cli.train_lora_scale",
    "sliders_conceptmod_tpu_torch.ops.flash_attention_kgrid",
    "sliders_conceptmod_tpu_torch.models.factory",
    "sliders_conceptmod_tpu_torch.models.clip",
    "sliders_conceptmod_tpu_torch.train.trainer",
}
# modules the sweep and loader slice added
SWEEP_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.cli.generate_images_xl",
    "sliders_conceptmod_tpu_torch.cli.generate_images_sd1",
    "sliders_conceptmod_tpu_torch.io.torch_convert",
    "sliders_conceptmod_tpu_torch.io.ldm_convert",
}
# modules the merged-route, DoRA and export slice added
MERGED_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.adapters.dora",
    "sliders_conceptmod_tpu_torch.io.ldm_export",
    "sliders_conceptmod_tpu_torch.cli.export_single_file",
    "sliders_conceptmod_tpu_torch.cli.combine_loras",
}

# modules the SD3 slice added or extended
SD3_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.models.mmdit",
    "sliders_conceptmod_tpu_torch.diffusion.flow_match",
    "sliders_conceptmod_tpu_torch.infer.generate_flow",
    "sliders_conceptmod_tpu_torch.train.esd_sd3",
    "sliders_conceptmod_tpu_torch.cli.train_lora_sd3",
    "sliders_conceptmod_tpu_torch.cli.generate_images_sd3",
    "sliders_conceptmod_tpu_torch.cli.train_notrigger",
    "sliders_conceptmod_tpu_torch.cli.quantize_checkpoint",
    "sliders_conceptmod_tpu_torch.models.vae",
    "sliders_conceptmod_tpu_torch.serve",
}
# modules the Flux slice added or extended
FLUX_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.models.flux",
    "sliders_conceptmod_tpu_torch.models.t5",
    "sliders_conceptmod_tpu_torch.models.tokenizer",
    "sliders_conceptmod_tpu_torch.models.norms",
    "sliders_conceptmod_tpu_torch.train.esd_flux",
    "sliders_conceptmod_tpu_torch.train.optim",
    "sliders_conceptmod_tpu_torch.train.notrigger",
    "sliders_conceptmod_tpu_torch.cli.train_lora_flux",
    "sliders_conceptmod_tpu_torch.cli.generate_images_flux",
    "sliders_conceptmod_tpu_torch.adapters.slider_file",
    "sliders_conceptmod_tpu_torch.io.safetensors",
}
# modules the image-decoding, scorer and null-text-inversion slice added or extended
IMAGE_EVAL_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.io.jpeg",
    "sliders_conceptmod_tpu_torch.io.png",
    "sliders_conceptmod_tpu_torch.io.image",
    "sliders_conceptmod_tpu_torch.train.imageslider",
    "sliders_conceptmod_tpu_torch.models.clip_vision",
    "sliders_conceptmod_tpu_torch.models.lpips",
    "sliders_conceptmod_tpu_torch.models.unet",
    "sliders_conceptmod_tpu_torch.eval.table",
    "sliders_conceptmod_tpu_torch.eval.clip_score",
    "sliders_conceptmod_tpu_torch.eval.lpip_score",
    "sliders_conceptmod_tpu_torch.infer.ptp",
    "sliders_conceptmod_tpu_torch.infer.null_inversion",
    "sliders_conceptmod_tpu_torch.demos.demo_image_editing",
    "sliders_conceptmod_tpu_torch.core.device",
}
# modules the baselines, acceptance, parity and demos slice added or extended (utils/ and demos/ included)
EVAL_REST_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.eval.baselines",
    "sliders_conceptmod_tpu_torch.eval.parity",
    "sliders_conceptmod_tpu_torch.cli.generate_images_uce",
    "sliders_conceptmod_tpu_torch.cli.generate_images_textinversion",
    "sliders_conceptmod_tpu_torch.cli.generate_images_textinversion_xl",
    "sliders_conceptmod_tpu_torch.cli.generate_images_customdiffusion",
    "sliders_conceptmod_tpu_torch.cli.acceptance",
    "sliders_conceptmod_tpu_torch.cli.make_config",
    "sliders_conceptmod_tpu_torch.cli.run_batch",
    "sliders_conceptmod_tpu_torch.core.yaml_subset",
    "sliders_conceptmod_tpu_torch.utils.debug",
    "sliders_conceptmod_tpu_torch.demos.demo_concept_sliders",
    "sliders_conceptmod_tpu_torch.demos.demo_sdxl_turbo",
}
# modules the parallelism slice added or extended: the mesh, ring attention, and the entry points whose
# workers a spawned world runs (the trainer CLIs, the sweep, serving)
PARALLEL_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.parallel",
    "sliders_conceptmod_tpu_torch.parallel.mesh",
    "sliders_conceptmod_tpu_torch.parallel.ring_attention",
    "sliders_conceptmod_tpu_torch.ops.attention",
    "sliders_conceptmod_tpu_torch.cli.train_lora_xl",
    "sliders_conceptmod_tpu_torch.cli.train_lora_sd3",
    "sliders_conceptmod_tpu_torch.cli.train_lora_flux",
    "sliders_conceptmod_tpu_torch.cli.train_lora_cascade",
}

# modules the image-format slice added or extended (WebP, arithmetic/CMYK/lossless JPEG, GIF, BMP, TIFF)
IMAGE_FORMAT_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.io.vp8",
    "sliders_conceptmod_tpu_torch.io.vp8l",
    "sliders_conceptmod_tpu_torch.io.webp",
    "sliders_conceptmod_tpu_torch.io.gif",
    "sliders_conceptmod_tpu_torch.io.bmp",
    "sliders_conceptmod_tpu_torch.io.tiff",
    "sliders_conceptmod_tpu_torch.io.jpeg",
    "sliders_conceptmod_tpu_torch.io.image",
}
# modules the slice of the formats Pillow reads beyond those added or extended
# (JPEG 2000, PNM, TGA, ICO/CUR, PSD, QOI; TIFF, lossless JPEG and BMP extended)
PILLOW_FORMAT_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.io.jpeg2000",
    "sliders_conceptmod_tpu_torch.io.j2k_tier1",
    "sliders_conceptmod_tpu_torch.io.j2k_dwt",
    "sliders_conceptmod_tpu_torch.io.pnm",
    "sliders_conceptmod_tpu_torch.io.tga",
    "sliders_conceptmod_tpu_torch.io.ico",
    "sliders_conceptmod_tpu_torch.io.psd",
    "sliders_conceptmod_tpu_torch.io.qoi",
    "sliders_conceptmod_tpu_torch.io.tiff",
    "sliders_conceptmod_tpu_torch.io.jpeg",
    "sliders_conceptmod_tpu_torch.io.bmp",
    "sliders_conceptmod_tpu_torch.io.png",
    "sliders_conceptmod_tpu_torch.io.image",
}

# modules the slice of the formats Pillow writes added or extended (TIFF's CCITT, ZSTD and YCbCr; PCX/DCX, SGI,
# DDS and its BCn blocks, FTEX, BLP, ICNS; the readers' shared pieces)
PILLOW_WRITES_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.io._common",
    "sliders_conceptmod_tpu_torch.io.ccitt",
    "sliders_conceptmod_tpu_torch.io.zstd",
    "sliders_conceptmod_tpu_torch.io.tiff",
    "sliders_conceptmod_tpu_torch.io.pcx",
    "sliders_conceptmod_tpu_torch.io.sgi",
    "sliders_conceptmod_tpu_torch.io.bcn",
    "sliders_conceptmod_tpu_torch.io.dds",
    "sliders_conceptmod_tpu_torch.io.icns",
    "sliders_conceptmod_tpu_torch.io.blp",
    "sliders_conceptmod_tpu_torch.io.ftex",
    "sliders_conceptmod_tpu_torch.io.jpeg",
    "sliders_conceptmod_tpu_torch.io.image",
}


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", CHECK, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split()[0])
    assert n >= 31  # every module of the package was walked (core/, train/ and cli/ included)
    walked = set(res.stdout.split(":", 1)[1].split())
    assert SD_SLICE_MODULES <= walked and SWEEP_SLICE_MODULES <= walked and MERGED_SLICE_MODULES <= walked
    assert SD3_SLICE_MODULES <= walked and FLUX_SLICE_MODULES <= walked and IMAGE_EVAL_SLICE_MODULES <= walked
    assert EVAL_REST_SLICE_MODULES <= walked and PARALLEL_SLICE_MODULES <= walked
    assert IMAGE_FORMAT_SLICE_MODULES <= walked and PILLOW_FORMAT_SLICE_MODULES <= walked
    assert PILLOW_WRITES_SLICE_MODULES <= walked


def test_spawned_worker_entry_points_import_without_jax():
    """A spawned rank imports its worker's module and nothing else of the
    parent: the tests' worker module (``tests/_torch_mesh_workers.py``) and
    the port's spawn entry (``parallel/mesh.py::_spawned``) load under the
    same refusals, and the source of the worker module imports nothing
    refused."""
    code = CHECK.split("import sliders_conceptmod_tpu_torch as pkg")[0] + textwrap.dedent(
        """
        spec = importlib.util.spec_from_file_location("_torch_mesh_workers", sys.argv[1])
        workers = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(workers)
        from sliders_conceptmod_tpu_torch.parallel import mesh
        assert callable(mesh._spawned) and callable(workers.esd_steps) and callable(workers.serve)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
        assert not leaked, leaked
        print("ok")
        """)
    workers = os.path.join(REPO, "tests", "_torch_mesh_workers.py")
    res = subprocess.run([sys.executable, "-c", code, workers], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
    assert not [top for top, _ in _imported_tops(workers) if top in REFUSED_TOP]


def test_refusal_hook_bites():
    """The hook above does refuse the JAX package (so a pass means something)."""
    code = CHECK.split("import sliders_conceptmod_tpu_torch as pkg")[0] + "import sliders_conceptmod_tpu\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "refused import of sliders_conceptmod_tpu" in res.stderr


REFUSED_TOP = {"jax", "jaxlib", "flax", "optax", "sliders_conceptmod_tpu", "yaml", "pydantic", "transformers",
               "tokenizers", "PIL", "safetensors", "regex", "pandas", "torchvision", "lpips", "zstandard"}


def _imported_tops(path):
    """Top-level names of every import statement in a file, at any depth."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((alias.name.split(".")[0], node.lineno) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_refused_import_anywhere_in_the_source():
    """Function-level (lazy) imports included."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "sliders_conceptmod_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 35
    found = [(os.path.relpath(f, REPO), line, top) for f in files for top, line in _imported_tops(f)
             if top in REFUSED_TOP]
    assert not found, found


def test_source_scan_bites():
    """A lazy import inside a function is found by the scan."""
    code = "def f():\n    from transformers import CLIPTokenizer\n    import PIL.Image\n"
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(code)
    try:
        assert sorted(top for top, _ in _imported_tops(f.name)) == ["PIL", "transformers"]
    finally:
        os.unlink(f.name)

"""Serving on a mesh (``serve.py`` with ``mesh_data`` / ``mesh_model``,
``parallel/mesh.py``) in a 2-rank gloo world on the CPU: a tiny-xl fp32
service whose rank 0 takes the requests — three one by one, the three
again as one micro-batch, and one for a slider registered at run time —
returns, for the same seeds, the images of the one-rank service (within
1/255: the rows' fp32 sums run in other orders), with ``--mesh_data 2``
(each rank samples its rows; the buckets and ``max_batch`` double, as in
JAX) and with ``--mesh_model 2`` (every row against each rank's UNet
shard). The other rank runs rank 0's broadcast ops and leaves when the
service closes."""

import numpy as np
import pytest

import _torch_mesh_workers as W
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
from test_torch_serve_registry import _unet_slider
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REQUESTS = [("a photo of a person", 1.5, 7, 7.5), ("a red car", -1.0, 3, 7.5), ("a dog", 0.0, 11, 7.5)]
KW = dict(image_size=64, steps=3, batch_window_ms=1.0)


@pytest.fixture(scope="module")
def sliders(tmp_path_factory):
    d = tmp_path_factory.mktemp("sliders")
    return (_unet_slider(d / "a.safetensors", "noxattn", 4, 1.0, 1),
            _unet_slider(d / "b.safetensors", "noxattn", 1, 4.0, 2))


@pytest.fixture(scope="module")
def one_rank(sliders):
    a, b = sliders
    svc = W.fp32_service("xl")("tiny-xl", a, device="cpu", **KW)
    try:
        return W.serve_requests(svc, REQUESTS, ("b", b, ("a cat", 2.0, 5, 7.5)))
    finally:
        svc.close()


@pytest.mark.parametrize("mesh,max_batch,buckets", [(dict(mesh_data=2), 8, (2, 4, 8)),
                                                    (dict(mesh_model=2), 4, (1, 2, 4))],
                         ids=["mesh_data", "mesh_model"])
def test_mesh_service_returns_the_one_rank_images(tmp_path, sliders, one_rank, mesh, max_batch, buckets):
    a, b = sliders
    tmesh.spawn_world(W.serve, (str(tmp_path), "xl", "tiny-xl", a, dict(KW, **mesh), REQUESTS,
                                ("b", b, ("a cat", 2.0, 5, 7.5))), 2, device="cpu")
    rank0, rank1 = W.load(tmp_path, 2)
    assert rank1["worker"] and not rank0["jax_loaded"] and not rank1["jax_loaded"]
    assert rank0["max_batch"] == max_batch and tuple(rank0["buckets"]) == buckets
    assert len(rank0["pngs"]) == len(one_rank) == 7
    for got, want in zip(rank0["pngs"], one_rank):
        assert np.abs(decode_png(got).astype(int) - decode_png(want).astype(int)).max() <= 1

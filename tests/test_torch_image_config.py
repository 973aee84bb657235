"""The benchmark's ``image`` configuration (``gpubench/configs/image.*``,
fogleman/sdf ``examples/image.py``) and its plain reference
(``gpubench/reference/textures.py``) on the CPU.

* The reference's exact Euclidean distance transform equals scipy's bit
  for bit: on ``butterfly.png`` (the configuration's image), on
  ``flower.png`` cut to 128 x 96, and on seeded random masks with rows
  all lit and all dark.
* The program's field of the plate equals the reference's at seeded
  random points and seeded draws of the edit traffic.  Tolerance: 0 ulp
  (both run the same torch operations in the same order on the CPU).
* ``generate()`` at 2^13 records one field and evaluates every bounds
  round on the CPU, and through the harness it is ``correct``.
* At 2^18, at the script's values and at a drawn request, the check
  reads the witness correct and the control and three faults of the
  texture not correct: the texture shifted one pixel, a city-block
  distance transform, and the texture's field computed in bfloat16.
* The configuration's frozen operations a sample, kernel B1's share.

The benchmark's modules are reached by path, as
``torch_helpers.bench_models`` reaches its files, with ``gpubench/`` put on
the import path for the harness's own imports.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage as nd
import torch
from PIL import Image

import sdf_torch

BENCH = Path(__file__).resolve().parent.parent / "gpubench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
import harness  # noqa: E402
from reference import mesh as ref_mesh  # noqa: E402
from reference import sdf as ref_sdf  # noqa: E402
from reference import textures as rt  # noqa: E402
from reference import work  # noqa: E402
from traffic import Traffic  # noqa: E402

CELL = "image.edit_2p22"
CONFIG = json.loads((BENCH / "configs" / "image.json").read_text())
SIZE = 2**18  # a 113 x 113 x 21 grid: a pixel is 0.09 grid steps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the meshes here are small, and the suite runs
    several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_module():
    spec = importlib.util.spec_from_file_location(
        "bench_image", BENCH / "configs" / "image.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CFG = _config_module()


def _draws(n, seed=19):
    """The script's values, then ``n - 1`` requests of the edit traffic."""
    spec = json.loads((BENCH / "traffic" / "edit_2p22.json").read_text())
    t = Traffic(spec, CONFIG, seed)
    return [t.nominal] + [t.request(i) for i in range(n - 1)]


# --- the distance transform ---------------------------------------------


def _random_mask(seed, shape, lit):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < lit
    m[rng.integers(shape[0])] = True
    m[rng.integers(shape[0])] = False
    m[:, rng.integers(shape[1])] = True
    return m


def _masks():
    def image(name, box=None):
        im = Image.open(BENCH.parent / "examples" / name).convert("L")
        if box is not None:
            im = im.crop(box)
        return np.array(im.convert("1"))

    return {
        "butterfly": lambda: image("butterfly.png"),
        "flower_128x96": lambda: image("flower.png", (100, 100, 228, 196)),
        "random_37x53": lambda: _random_mask(1, (37, 53), 0.5),
        "random_64x64_sparse": lambda: _random_mask(2, (64, 64), 0.05),
        "random_96x40_dense": lambda: _random_mask(3, (96, 40), 0.97),
    }


@pytest.mark.parametrize("name", list(_masks()))
def test_reference_edt_equals_scipy(name):
    mask = _masks()[name]()
    assert mask.any() and not mask.all()
    for m in (mask, ~mask):
        got = rt.edt(m, device="cpu")
        want = nd.distance_transform_edt(m)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want), name


def test_the_image_is_not_resized():
    mask = rt._mask(CFG.IMAGE, rt.PIXELS)
    assert mask.shape == (1024, 1024) and mask.size <= rt.PIXELS
    assert CFG.build(ref_sdf, CONFIG["params"]) is not None


# --- the field and the mesh ----------------------------------------------


@pytest.mark.parametrize("draw", range(3))
def test_plate_field_equals_reference(draw):
    v = _draws(3)[draw]
    rng = np.random.default_rng([draw, 7])
    pts = rng.uniform(-0.75, 0.75, (50_000, 3))
    pts[:, 2] *= 0.2  # the plate's thickness: most points near the relief
    p = torch.tensor(pts, dtype=torch.float32)
    got = CFG.build(sdf_torch, v)(p).reshape(-1)
    field = ref_sdf.field(CFG.build(ref_sdf, v), torch.float32, "cpu")
    want = field(ref_sdf.Points(*p.T.contiguous()))
    assert torch.equal(got, want)


def test_the_plate_takes_the_field_route():
    from sdf_torch.core import engine, spans

    spans._take_held()
    f = CFG.build(sdf_torch, _draws(2)[1])
    sdf_torch.generate(f, samples=2**13, verbose=False, device="cpu")
    st = engine.LAST_STATS
    assert st["recorded_fields"] == 1 and st["texture"] > 0
    assert st["bounds_cpu_rounds"] == st["bounds_rounds"] > 1


def test_generate_through_the_harness_is_correct():
    cell = harness.Cell(CELL)
    cell.traffic = dict(cell.traffic, samples=2**13, check_requests=2)
    result, rows = harness.run(cell, 2**31 + 19, 1.0, False, "cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert rows[0][0] == "checked_requests" and 1 <= rows[0][1] <= 2


def _texture_node(tree):
    """The reference expression's texture node."""
    if isinstance(tree, ref_sdf.SDF3):
        if isinstance(tree.params, dict) and "texture" in tree.params:
            return tree
        tree = tree.params
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for x in items:
        found = _texture_node(x)
        if found is not None:
            return found
    return None


def _shifted(node):
    """The texture moved one pixel along x."""
    node.params["texture"] = np.roll(node.params["texture"], 1, axis=1)


def _city_block(node):
    """The signed texture from a city-block distance transform."""
    mask = rt._mask(CFG.IMAGE, rt.PIXELS)
    d = np.where(mask, -nd.distance_transform_cdt(mask, metric="taxicab"),
                 nd.distance_transform_cdt(~mask, metric="taxicab"))
    node.params["texture"] = d.astype(np.float64) / mask.shape[1]


def _bfloat16(node):
    """The texture's field (texture, points and lookup) computed in
    bfloat16, the precision below float32, as a pre-pass in it would."""
    fn = node.fn

    def low(q, p):
        q16 = ref_sdf._tree_map(lambda t: t.to(torch.bfloat16), q)
        p16 = ref_sdf.Points(*[c.to(torch.bfloat16) for c in p.c])
        return fn(q16, p16).to(p.c[0].dtype)

    node.fn = low


FAULTS = {"shifted_one_pixel": _shifted, "city_block_edt": _city_block,
          "bfloat16_texture": _bfloat16}


@pytest.fixture(scope="module", params=[0, 1], ids=["script", "drawn"])
def request_(request):
    """A request's values and the reference's mesh of them."""
    v = _draws(2)[request.param]
    return v, ref_mesh.mesh(CFG.build(ref_sdf, v), SIZE, "cpu")


def _reads_correct(expr, ref, **kw):
    soup = ref_mesh.mesh(expr, SIZE, "cpu", **kw)["soup"]
    verts = soup.reshape(-1, 3).numpy()
    faces = np.arange(len(verts)).reshape(-1, 3)
    got = check.compare(verts, faces, ref)
    limits = CONFIG["limits"]
    return all(got[k] <= limits[k] for k in limits), got


def test_witness_is_correct(request_):
    v, ref = request_
    ok, got = _reads_correct(CFG.build(ref_sdf, v), ref,
                             field_dtype=torch.float64, nudge=1)
    assert ok and got["vert_gap"] > 0, got


def test_control_is_not_correct(request_):
    v, ref = request_
    ok, got = _reads_correct(CFG.build(ref_sdf, v), ref,
                             field_dtype=torch.bfloat16)
    assert not ok, got


@pytest.mark.parametrize("fault", list(FAULTS))
def test_texture_fault_is_not_correct(request_, fault):
    v, ref = request_
    expr = CFG.build(ref_sdf, v)
    FAULTS[fault](_texture_node(expr))
    ok, got = _reads_correct(expr, ref)
    assert not ok, got


# --- the frozen work -----------------------------------------------------


def test_frozen_flops_per_sample_are_b1s_share():
    expr = CFG.build(ref_sdf, CONFIG["params"])
    total, ops = work.flops_per_sample(rt.recorded(expr))
    assert total == CONFIG["work"]["flops_per_sample"], ops
    # the texture's lookup and its fallback run in the pre-pass
    assert work.flops_per_sample(expr)[0] > total
    scaled = {k: 1.05 * v for k, v in CONFIG["params"].items()}
    assert work.flops_per_sample(
        rt.recorded(CFG.build(ref_sdf, scaled)))[0] == total

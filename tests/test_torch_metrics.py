"""The port's quality metrics against the JAX package on the CPU: LPIPS
(AlexNet, both loaders on the same torch-layout state dicts), NIQE and
BRISQUE (``metrics/noref.py``), NRQM and PI (``metrics/nrqm.py``), scored
with synthetic model files of the released layouts built in ``tmp_path``,
and VMAF's two ffmpeg wrappers under the same mocked subprocess.

Bars: LPIPS within 1e-5 relative; every numpy metric within 1e-6 relative
(no absolute slack); VMAF's argv and score equal.
"""

import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from fcvsr_tpu.metrics import lpips as JL
from fcvsr_tpu.metrics import noref as JN
from fcvsr_tpu.metrics import nrqm as JQ
from fcvsr_tpu.metrics import vmaf as JV
from fcvsr_tpu_torch.metrics import lpips as PL
from fcvsr_tpu_torch.metrics import noref as PN
from fcvsr_tpu_torch.metrics import nrqm as PQ
from fcvsr_tpu_torch.metrics import vmaf as PV

RTOL = 1e-6
LPIPS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def textured(h, w, seed):
    """A smooth random image in [0, 255]: 8 x 8 blocks, bilinear."""
    base = np.random.default_rng(seed).uniform(0, 255, (h // 8 + 1,
                                                        w // 8 + 1))
    ys = np.linspace(0, base.shape[0] - 1, h)
    xs = np.linspace(0, base.shape[1] - 1, w)
    rows = np.array([np.interp(xs, np.arange(base.shape[1]), r)
                     for r in base])
    return np.array([np.interp(ys, np.arange(base.shape[0]), c)
                     for c in rows.T]).T


# --------------------------------- LPIPS -------------------------------------

def lpips_states(seed):
    """Random torchvision ``alexnet.features`` and lpips v0.1 head state
    dicts (OIHW tensors)."""
    rng = np.random.default_rng(seed)
    shapes = {"0": (64, 3, 11, 11), "3": (192, 64, 5, 5),
              "6": (384, 192, 3, 3), "8": (256, 384, 3, 3),
              "10": (256, 256, 3, 3)}
    backbone, lin = {}, {}
    for key, shape in shapes.items():
        bound = 1 / np.sqrt(np.prod(shape[1:]))
        backbone[f"{key}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32))
        backbone[f"{key}.bias"] = torch.from_numpy(
            rng.uniform(-0.1, 0.1, shape[0]).astype(np.float32))
    for i, c in enumerate((64, 192, 384, 256, 256)):
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32))
    return backbone, lin


def test_lpips_matches_jax():
    """Two 64 x 64 pairs in [0, 1] through both loaders, within 1e-5
    relative; a wrong-shaped head raises ValueError."""
    backbone, lin = lpips_states(0)
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    jmodel = JL.LPIPSAlex()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(a), jnp.asarray(b))
    params = JL.load_torch_lpips_weights(backbone, lin, shapes)
    want = jax.jit(lambda p, x, y: JL.lpips_distance(jmodel, p, x, y))(
        params, jnp.asarray(a), jnp.asarray(b))
    model = PL.load_torch_lpips_weights(backbone, lin,
                                        PL.LPIPSAlex(device="cpu"))
    with torch.no_grad():
        got = PL.lpips_distance(model, a, b)
    assert got.shape == (2,) and float(got.min()) > 0
    same(got.numpy(), want, LPIPS_RTOL)
    bad = dict(lin, **{"lin2.model.1.weight": torch.zeros(1, 256, 1, 1)})
    with pytest.raises(ValueError, match="lin2"):
        PL.load_torch_lpips_weights(backbone, bad, PL.LPIPSAlex(device="cpu"))


def test_lpips_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        assert next(PL.LPIPSAlex().parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            PL.LPIPSAlex()


# -------------------------------- noref --------------------------------------

def test_matlab_imresize_matches_jax():
    img = textured(37, 50, 2)
    for kw in (dict(scale=0.5), dict(scale=2.0), dict(sizes=(20, 13))):
        same(PN.matlab_imresize(img, **kw), JN.matlab_imresize(img, **kw))


def test_niqe_and_brisque_features_match_jax():
    img = textured(192, 200, 3)
    same(PN.niqe_features(img), JN.niqe_features(img))
    same(PN.brisque_features(img), JN.brisque_features(img))


@pytest.fixture
def niqe_mat(tmp_path):
    """A pristine-model file of the released layout: mu (1, 36) and an SPD
    cov (36, 36)."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(36, 36))
    path = tmp_path / "niqe_modelparameters.mat"
    scipy.io.savemat(path, {"mu_prisparam": rng.uniform(0, 2, (1, 36)),
                            "cov_prisparam": a @ a.T / 36 + np.eye(36)})
    return str(path)


def test_calculate_niqe_matches_jax(niqe_mat):
    """BGR and RGB luma, and the channel mean, with a crop."""
    rgb = np.stack([textured(200, 208, s) for s in (5, 6, 7)], -1)
    for kw in (dict(), dict(channel_order="rgb", crop_border=4),
               dict(convert_to=None)):
        same(PN.calculate_niqe(rgb, niqe_mat, **kw),
             JN.calculate_niqe(rgb, niqe_mat, **kw))


def test_calculate_brisque_matches_jax(tmp_path):
    """The released SVR layout, (sv_coef, sv) tensors in a ``.pth``, in both
    orientations of sv."""
    rng = np.random.default_rng(8)
    coef = torch.from_numpy(rng.uniform(-2, 2, (25, 1)).astype(np.float32))
    sv = torch.from_numpy(rng.uniform(-1, 1, (25, 36)).astype(np.float32))
    rgb = np.stack([textured(96, 112, s) for s in (9, 10, 11)], -1)
    for i, v in enumerate((sv, sv.T.contiguous())):
        path = str(tmp_path / f"svm{i}.pth")
        torch.save((coef, v), path)
        for kw in (dict(), dict(channel_order="rgb"), dict(convert_to=None)):
            same(PN.calculate_brisque(rgb, path, **kw),
                 JN.calculate_brisque(rgb, path, **kw))


# --------------------------------- nrqm --------------------------------------

def test_nrqm_primitives_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(5, 300)) * rng.uniform(0.5, 3, (5, 1))
    same(PQ.gamma_gen_gauss(x), JQ.gamma_gen_gauss(x))
    img = textured(48, 56, 13)
    got, want = PQ.scf_pyramid(img), JQ.scf_pyramid(img)
    assert len(got) == len(want) == 4
    same(got[0], want[0])
    same(got[-1], want[-1])
    for gl, wl in zip(got[1:-1], want[1:-1]):
        for g, w in zip(gl, wl):
            same(g, w)


def random_forest(n_feat, seed, n_nodes=15, n_trees=8):
    """A random forest of perfect binary trees in the MATLAB layout
    (1-based children, 0 a leaf)."""
    rng = np.random.default_rng(seed)
    ldau = np.zeros((n_nodes, n_trees), np.int64)
    rdau = np.zeros((n_nodes, n_trees), np.int64)
    for k in range(n_nodes // 2):
        ldau[k], rdau[k] = 2 * k + 2, 2 * k + 3
    return (ldau, rdau, rng.normal(size=(n_nodes, n_trees)),
            rng.normal(size=(n_nodes, n_trees)),
            rng.integers(1, n_feat + 1, size=(n_nodes, n_trees)))


def test_random_forest_matches_jax():
    forest = random_forest(10, 14)
    for seed in range(3):
        feat = np.random.default_rng(seed).normal(size=10)
        same(PQ.random_forest_predict(feat, *forest),
             JQ.random_forest_predict(feat, *forest))


@pytest.fixture
def nrqm_mat(tmp_path):
    """An ``NRQM_model.mat`` of the released layout: a linear blend and
    three forests (18, 45 and 75 features) in MATLAB structs."""
    cells = np.empty((1, 3), object)
    for i, (n_feat, seed) in enumerate(((18, 15), (45, 16), (75, 17))):
        ldau, rdau, thr, pred, attr = random_forest(n_feat, seed)
        rec = np.zeros((1, 1), dtype=[(n, object) for n in (
            "ldau", "rdau", "x2", "x3", "threshold", "pred", "attr")])
        rec[0, 0] = (ldau, rdau, np.zeros(1), np.zeros(1), thr, pred, attr)
        cells[0, i] = rec
    model = np.zeros((1, 1), dtype=[("linear", object), ("rf", object)])
    model[0, 0] = (np.array([[0.5], [1.0], [-1.0], [2.0]]), cells)
    path = tmp_path / "NRQM_model.mat"
    scipy.io.savemat(path, {"model": model})
    return str(path)


def test_nrqm_and_pi_match_jax(nrqm_mat, niqe_mat):
    """The three feature families, NRQM and PI (crop 4, NIQE on the
    cropped 104 x 112) on one image."""
    img = textured(112, 120, 18)
    for g, w in zip(PQ.nrqm_features(img), JQ.nrqm_features(img)):
        same(g, w)
    same(PQ.calculate_nrqm(img, nrqm_mat), JQ.calculate_nrqm(img, nrqm_mat))
    same(PQ.calculate_pi(img, nrqm_mat, niqe_mat),
         JQ.calculate_pi(img, nrqm_mat, niqe_mat))
    with pytest.raises(FileNotFoundError):
        PQ.calculate_nrqm(img, nrqm_mat + ".missing")


# --------------------------------- VMAF --------------------------------------

LOG = {"pooled_metrics": {"vmaf": {"mean": 93.3}}}


def vmaf_mocks():
    """A fake ``subprocess.run`` that writes libvmaf's JSON log, and a fake
    ``Popen`` whose merged output holds the score line; both record their
    calls."""
    calls = []

    def run(cmd, **kw):
        calls.append(("run", cmd, kw.get("cwd")))
        if "-filter_complex" in cmd:
            log = cmd[cmd.index("-filter_complex") + 1].split("log_path=")[1]
            with open(log, "w") as f:
                json.dump(LOG, f)
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    class Popen:
        def __init__(self, cmd, stdout=None, stderr=None):
            calls.append(("popen", cmd, (stdout, stderr)))

        def communicate(self):
            return b"[libvmaf @ 0x5] VMAF score: 91.12345\n", None

    return calls, run, Popen


def strip_logs(calls):
    """The calls with the temporary log path cut out of the filter."""
    return [(k, [a.split("log_path=")[0] for a in cmd], x)
            for k, cmd, x in calls]


def test_vmaf_matches_jax():
    """Both wrappers' argv (the temporary log path aside) and parsed scores
    under the same mocks; without ffmpeg on the PATH, a clear error."""
    results = []
    for mod in (PV, JV):
        calls, run, popen = vmaf_mocks()
        a = mod.calculate_vmaf("/d/dist", "/d/ref", 480, 272, fps=25,
                               _run=run)
        b = mod.calculate_vmaf_reference("/r/seq", "/g/seq", "/r/s.mkv",
                                         "/g/s.mkv", _run=run, _popen=popen)
        results.append((a, b, strip_logs(calls)))
    assert results[0] == results[1]
    # the reference reads the 8 characters after 'VMAF score:', the space
    # included
    assert results[0][:2] == (93.3, 91.1234)
    assert PV.ffmpeg_available() == JV.ffmpeg_available()
    if not PV.ffmpeg_available():
        with pytest.raises(RuntimeError, match="ffmpeg"):
            PV.calculate_vmaf("/d/dist", "/d/ref", 480, 272)

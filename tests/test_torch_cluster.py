"""The port's classical clustering (`pctpu_torch.cluster`) and the
clustering harness (`pipelines.cluster_compare`) against the JAX package,
on the CPU. Inputs come from numpy with a seed; both sides get the same
draws: the port's injected draws are JAX's own (`categorical` for
k-means' first centre, the Gumbel top-3 for the plane's triples), taken
on the mask the port hands them.

Tolerances: k-means labels and n_iter equal, centres within 1e-6 (the
centre sums add in ascending index on both sides, kernel 14's plain
version and XLA's scatter-add); GMM means, covariances and weights within
1e-4, nll within 1e-5 relative, n_iter and predictions equal; spectral
clustering the same partition, and the embedding's projector E E^T within
1e-4 where the eigengap past it exceeds 1e-3 (eigenvectors of a repeated
eigenvalue are arbitrary in both LAPACKs); DBSCAN labels equal exactly;
plane normal and offset within 1e-5, inlier masks equal except within
1e-5 of the threshold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu import cluster as jcluster
from pctpu.cluster.dbscan import dbscan_exact as j_dbscan_exact
from pctpu.cluster import spectral as jspectral
from pctpu_torch import cluster as tcluster
from pctpu_torch.cluster.dbscan import dbscan_exact as t_dbscan_exact
from pctpu_torch.cluster import spectral as tspectral
from pctpu_torch.pipelines import cluster_compare


def blobs(n=300, seed=0, std=0.6):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [4.0, 1.0], [1.5, 4.5]])
    lab = np.arange(n) % 3
    return (centers[lab] + rng.normal(scale=std, size=(n, 2))).astype(
        np.float32)


def moons(n=300, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    h = n // 2
    t1 = rng.uniform(0, np.pi, h)
    t2 = rng.uniform(0, np.pi, n - h)
    x = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                        np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)])
    return (x + rng.normal(scale=noise, size=x.shape)).astype(np.float32)


def circles(n=200, seed=0, factor=0.4, noise=0.04):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    r = np.where(np.arange(n) % 2 == 0, 1.0, factor)
    x = np.stack([r * np.cos(t), r * np.sin(t)], 1)
    return (x + rng.normal(scale=noise, size=x.shape)).astype(np.float32)


def jax_first(key):
    """The reference's first-centre draw on the mask the port hands over."""
    def first(mask):
        m = jnp.asarray(mask.cpu().numpy())
        return int(jax.random.categorical(key, jnp.where(m, 0.0, -1e9)))
    return first


def jax_plane_sampler(key):
    """The reference's Gumbel top-3 triples on the port's vote mask."""
    def sample(vote_mask, h):
        m = jnp.asarray(vote_mask.cpu().numpy())
        g = jax.random.gumbel(key, (h, m.shape[0])) + jnp.where(
            m, 0.0, -1e9)[None, :]
        return torch.from_numpy(np.array(jax.lax.top_k(g, 3)[1]))
    return sample


def same_partition(a, b):
    """Labels a and b split the points alike (a bijection of ids)."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return (len(pairs) == len(set(a.tolist())) == len(set(b.tolist())))


def purity(labels, truth):
    """Share of points whose cluster's majority class is their class."""
    labels, truth = np.asarray(labels), np.asarray(truth)
    hits = sum(np.bincount(truth[labels == c]).max()
               for c in np.unique(labels))
    return hits / len(labels)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_matches_jax(masked):
    x = blobs()
    mask = (np.arange(len(x)) % 7 != 3) if masked else None
    key = jax.random.PRNGKey(3)
    jc, jl, jn = jcluster.kmeans(jnp.asarray(x), 3, key=key,
                                 mask=None if mask is None
                                 else jnp.asarray(mask))
    tc, tl, tn = tcluster.kmeans(_t(x), 3, first=jax_first(key),
                                 mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tn == int(jn)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


def test_kmeans_shim_and_default_draw():
    """The shim on the CPU: a fit, predict consistent with labels_, and
    the default first-centre draw repeats for one seed."""
    x = blobs(seed=1)
    a = tcluster.K_Means(3, seed=4, device="cpu").fit(x)
    b = tcluster.K_Means(3, seed=4, device="cpu").fit(x)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    np.testing.assert_array_equal(a.predict(x), a.labels_)
    assert purity(a.labels_, np.arange(len(x)) % 3) > 0.95


def test_gmm_matches_jax():
    x = blobs()
    key = jax.random.PRNGKey(1)
    js = jcluster.gmm_fit(jnp.asarray(x), 3, key=key)
    ts = tcluster.gmm_fit(_t(x), 3, first=jax_first(key))
    for name in ("means", "covs", "weights"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(ts.nll), float(js.nll), rtol=1e-5)
    assert ts.n_iter == int(js.n_iter)
    np.testing.assert_array_equal(
        tcluster.gmm_predict(ts, _t(x)).numpy(),
        np.asarray(jcluster.gmm_predict(js, jnp.asarray(x))))
    g = tcluster.GMM(3, device="cpu").fit(x)
    assert float(g.state.weights.sum()) == pytest.approx(1.0, abs=1e-5)
    assert purity(g.predict(x), np.arange(len(x)) % 3) > 0.95


def test_spectral_matches_jax():
    x = circles()
    key = jax.random.PRNGKey(0)
    jl = jcluster.spectral_clustering(jnp.asarray(x), 2, nnk=10, key=key)
    tl = tcluster.spectral_clustering(_t(x), 2, nnk=10, first=jax_first(key))
    assert same_partition(tl.numpy(), np.asarray(jl))
    assert same_partition(tl.numpy(), np.arange(len(x)) % 2)
    # the embedding's projector where the eigengap after it is open
    k = 4
    je = np.asarray(jspectral.spectral_embedding(jnp.asarray(x), k, nnk=10))
    te = tspectral.spectral_embedding(_t(x), k, nnk=10).numpy()
    w = np.linalg.eigvalsh(np.asarray(_laplacian(x, 10)))
    checked = 0
    for j in range(1, k + 1):
        if w[j] - w[j - 1] > 1e-3:
            np.testing.assert_allclose(te[:, :j] @ te[:, :j].T,
                                       je[:, :j] @ je[:, :j].T, atol=1e-4)
            checked += 1
    assert checked >= 1


def _laplacian(x, nnk):
    """The normalised Laplacian in float64, for its eigengaps."""
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)
    n = len(x)
    W = np.zeros((n, n))
    for i in range(n):
        for j in np.argsort(d[i], kind="stable")[:nnk + 1]:
            if j != i:
                W[i, j] = max(W[i, j], 1.0 / max(d[i, j], 1e-10))
    W = np.maximum(W, W.T)
    dinv = 1.0 / np.sqrt(W.sum(1))
    return np.eye(n) - dinv[:, None] * W * dinv[None, :]


@pytest.mark.parametrize("masked", [False, True])
def test_dbscan_matches_jax(masked):
    x = moons()
    mask = (np.arange(len(x)) % 5 != 0) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    jl = jcluster.dbscan(jnp.asarray(x), 0.2, 5, mask=jm, k_cap=32)
    tl = tcluster.dbscan(_t(x), 0.2, 5, mask=tm, k_cap=32)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert len(np.unique(tl.numpy()[tl.numpy() >= 0])) == 2


def test_dbscan_exact_dense_bridge_matches_jax():
    """tests/test_cluster.py's two hyper-dense poles inside one eps-ball:
    the escalation keeps them one cluster, labels equal the reference's."""
    rng = np.random.default_rng(0)
    pole_a = rng.normal(scale=0.01, size=(80, 2)).astype(np.float32)
    pole_b = (rng.normal(scale=0.01, size=(80, 2))
              + np.array([0.5, 0.0])).astype(np.float32)
    pts = np.concatenate([pole_a, pole_b])
    jl = np.asarray(j_dbscan_exact(jnp.asarray(pts), eps=0.6,
                                             min_pts=5, k_cap=16))
    tl = t_dbscan_exact(_t(pts), eps=0.6, min_pts=5,
                                  k_cap=16).numpy()
    np.testing.assert_array_equal(tl, jl)
    assert (tl == 0).all()
    # without escalation the k_cap = 16 subgraph splits the bridge, alike
    np.testing.assert_array_equal(
        tcluster.dbscan(_t(pts), 0.6, 5, k_cap=16).numpy(),
        np.asarray(jcluster.dbscan(jnp.asarray(pts), 0.6, 5, k_cap=16)))


def test_dbscan_shim_marks_an_outlier():
    x = np.vstack([blobs(n=200, std=0.4, seed=2),
                   np.array([[50.0, 50.0]], np.float32)])
    labels = tcluster.DBSCAN(radius=1.0, Min_Pts=5, device="cpu").fit(x)
    assert labels.predict()[-1] == -1


def _plane_cloud(seed=0, n_in=800, n_out=200):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n_in + n_out, 3), np.float32)
    pts[:n_in, :2] = rng.uniform(-10, 10, (n_in, 2))
    pts[:n_in, 2] = 1.5 + rng.normal(scale=0.05, size=n_in)
    pts[n_in:] = rng.uniform(-10, 10, (n_out, 3))
    normals = np.zeros_like(pts)
    normals[:n_in, 2] = 1.0
    normals[n_in:] = rng.normal(size=(n_out, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals.astype(np.float32)


def _masks_equal_off_threshold(got, ref, pts, normal, offset, thresh):
    dist = np.abs(pts.astype(np.float64) @ normal + offset)
    near = np.abs(dist - thresh) <= 1e-5
    np.testing.assert_array_equal(got[~near], ref[~near])


@pytest.mark.parametrize("refine", [True, False])
def test_plane_ransac_matches_jax(refine):
    pts, _ = _plane_cloud()
    key = jax.random.PRNGKey(0)
    jr = jcluster.plane_ransac(jnp.asarray(pts), dist_thresh=0.2, key=key,
                               num_hypotheses=128, refine=refine)
    tr = tcluster.plane_ransac(_t(pts), dist_thresh=0.2, num_hypotheses=128,
                               refine=refine, sampler=jax_plane_sampler(key))
    np.testing.assert_allclose(tr.normal.numpy(), np.asarray(jr.normal),
                               atol=1e-5)
    np.testing.assert_allclose(float(tr.offset), float(jr.offset), atol=1e-5)
    _masks_equal_off_threshold(tr.inlier_mask.numpy(),
                               np.asarray(jr.inlier_mask), pts,
                               np.asarray(jr.normal), float(jr.offset), 0.2)
    assert abs(float(tr.normal[2])) > 0.999


def test_segment_ground_matches_jax():
    pts, normals = _plane_cloud(seed=1)
    mask = np.arange(len(pts)) % 9 != 4
    key = jax.random.PRNGKey(1)
    jg, jr = jcluster.segment_ground(
        jnp.asarray(pts), jnp.asarray(mask), dist_thresh=0.3,
        num_hypotheses=64, key=key, normals=jnp.asarray(normals))
    tg, tr = tcluster.segment_ground(
        _t(pts), _t(mask), dist_thresh=0.3, num_hypotheses=64,
        normals=_t(normals), sampler=jax_plane_sampler(key))
    np.testing.assert_allclose(tr.normal.numpy(), np.asarray(jr.normal),
                               atol=1e-5)
    np.testing.assert_allclose(float(tr.offset), float(jr.offset), atol=1e-5)
    _masks_equal_off_threshold(tg.numpy(), np.asarray(jg), pts,
                               np.asarray(jr.normal), float(jr.offset), 0.3)


def test_default_plane_draw_repeats_and_finds_the_plane():
    pts, _ = _plane_cloud(seed=2)
    a = tcluster.plane_ransac(_t(pts), generator=torch.Generator(
        ).manual_seed(5))
    b = tcluster.plane_ransac(_t(pts), generator=torch.Generator(
        ).manual_seed(5))
    assert torch.equal(a.normal, b.normal)
    assert torch.equal(a.inlier_mask, b.inlier_mask)
    assert abs(float(a.normal[2])) > 0.999
    assert a.inlier_mask[:800].float().mean() > 0.98


def test_cluster_compare_runs_the_port_on_the_cpu():
    """The harness with the port's four shims on the CPU, without the
    sklearn panel: every dataset, every algorithm, labels of the right
    length and a time."""
    res = cluster_compare.run_comparison(120, include_sklearn=False,
                                         device="cpu")
    assert list(res) == ["noisy_circles", "noisy_moons", "varied", "aniso",
                         "blobs", "no_structure"]
    for algos in res.values():
        assert [a for a in algos] == ["pctpu_KMeans", "pctpu_GMM",
                                      "pctpu_Spectral", "pctpu_DBSCAN"]
        for e in algos.values():
            assert e["labels"].shape == (120,) and e["time_s"] > 0


def test_cluster_shims_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = blobs(n=30)
    for shim in (tcluster.K_Means(3), tcluster.GMM(3),
                 tcluster.spetral_clustering(2), tcluster.DBSCAN()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shim.fit(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_compare.run_comparison(30, include_sklearn=False)

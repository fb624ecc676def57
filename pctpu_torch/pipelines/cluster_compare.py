"""Clustering comparison harness.

Re-design of `Cluster_KMeans_GMM/compare_cluster.py:20-193` (C10): the six
synthetic sklearn datasets x our algorithms (+ sklearn counterparts as the
oracle), per-fit wall-clock, and an optional scatter-grid PNG (headless
matplotlib instead of an interactive window).

The port's copy: `our_algorithms` returns the port's shims on the
requested device; scikit-learn is imported inside the functions that use
it, as the reference does (the datasets, the scaler, the oracle panel,
the ARI), so without it they raise ImportError.

Run: python -m pctpu_torch.pipelines.cluster_compare [--png out.png]
     [--n 500] [--no-sklearn] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from pctpu_torch.device import DeviceLike, resolve_device


def make_datasets(n_samples: int = 500, seed: int = 30):
    """The reference's six synthetic datasets (compare_cluster.py:20-47)."""
    from sklearn import datasets
    noisy_circles = datasets.make_circles(n_samples=n_samples, factor=0.5,
                                          noise=0.05, random_state=seed)
    noisy_moons = datasets.make_moons(n_samples=n_samples, noise=0.05,
                                      random_state=seed)
    blobs = datasets.make_blobs(n_samples=n_samples, random_state=8)
    rng = np.random.default_rng(seed)
    no_structure = (rng.random((n_samples, 2)), None)
    X, y = datasets.make_blobs(n_samples=n_samples, random_state=170)
    aniso = (np.dot(X, [[0.6, -0.6], [-0.4, 0.8]]), y)
    varied = datasets.make_blobs(n_samples=n_samples,
                                 cluster_std=[1.0, 2.5, 0.5],
                                 random_state=170)
    return [
        ("noisy_circles", noisy_circles, 2),
        ("noisy_moons", noisy_moons, 2),
        ("varied", varied, 3),
        ("aniso", aniso, 3),
        ("blobs", blobs, 3),
        ("no_structure", no_structure, 3),
    ]


def our_algorithms(n_clusters: int, device: DeviceLike = None
                   ) -> List[Tuple[str, Callable]]:
    """The port's four shims on `device` (CUDA unless "cpu" is asked
    for), with the reference's parameters."""
    from pctpu_torch.cluster import DBSCAN, GMM, K_Means, spetral_clustering

    dev = resolve_device(device)
    return [
        ("pctpu_KMeans",
         lambda X: K_Means(n_clusters, device=dev).fit(X).labels_),
        ("pctpu_GMM",
         lambda X: GMM(n_clusters, device=dev).fit(X).predict(X)),
        ("pctpu_Spectral",
         lambda X: spetral_clustering(n_clusters, nnk=10,
                                      device=dev).fit(X).labels_),
        ("pctpu_DBSCAN",
         lambda X: DBSCAN(radius=0.3, Min_Pts=5, device=dev).fit(X).labels_),
    ]


def sklearn_algorithms(n_clusters: int) -> List[Tuple[str, Callable]]:
    """The reference's full 10-algorithm sklearn panel
    (`compare_cluster.py:109-143`), with its parameterization: MeanShift's
    estimated bandwidth (quantile .3), Ward/average-linkage on a symmetrized
    10-NN connectivity graph, AffinityPropagation damping .9 / preference
    -200, OPTICS min_samples 20 / xi .05 / min_cluster_size .1."""
    from sklearn import cluster, mixture
    from sklearn.neighbors import kneighbors_graph

    def _connectivity(X):
        conn = kneighbors_graph(X, n_neighbors=10, include_self=False)
        return 0.5 * (conn + conn.T)

    def _meanshift(X):
        bw = cluster.estimate_bandwidth(X, quantile=0.3)
        return cluster.MeanShift(bandwidth=bw,
                                 bin_seeding=True).fit_predict(X)

    def _ward(X):
        return cluster.AgglomerativeClustering(
            n_clusters=n_clusters, linkage="ward",
            connectivity=_connectivity(X)).fit_predict(X)

    def _average(X):
        return cluster.AgglomerativeClustering(
            linkage="average", metric="cityblock", n_clusters=n_clusters,
            connectivity=_connectivity(X)).fit_predict(X)

    return [
        ("sk_KMeans", lambda X: cluster.KMeans(
            n_clusters, n_init=3).fit_predict(X)),
        ("sk_MiniBatchKMeans", lambda X: cluster.MiniBatchKMeans(
            n_clusters=n_clusters, n_init=3).fit_predict(X)),
        ("sk_GMM", lambda X: mixture.GaussianMixture(
            n_clusters, covariance_type="full").fit_predict(X)),
        ("sk_Spectral", lambda X: cluster.SpectralClustering(
            n_clusters, affinity="nearest_neighbors",
            n_neighbors=10, assign_labels="kmeans").fit_predict(X)),
        ("sk_DBSCAN", lambda X: cluster.DBSCAN(
            eps=0.3, min_samples=5).fit_predict(X)),
        ("sk_OPTICS", lambda X: cluster.OPTICS(
            min_samples=20, xi=0.05,
            min_cluster_size=0.1).fit_predict(X)),
        ("sk_MeanShift", _meanshift),
        ("sk_AffinityPropagation", lambda X: cluster.AffinityPropagation(
            damping=0.9, preference=-200,
            random_state=0).fit_predict(X)),
        ("sk_Ward", _ward),
        ("sk_Agglomerative", _average),
        ("sk_Birch", lambda X: cluster.Birch(
            n_clusters=n_clusters).fit_predict(X)),
    ]


def run_comparison(n_samples: int = 500, include_sklearn: bool = True,
                   device: DeviceLike = None) -> Dict[str, Dict[str, Dict]]:
    """Every dataset through the port's shims on `device` (CUDA unless
    "cpu" is asked for) and, with `include_sklearn`, the sklearn panel:
    {dataset: {algorithm: {"time_s", "labels"[, "ari"]}}}. A fit's time
    ends with its labels on the host."""
    dev = resolve_device(device)
    from sklearn.preprocessing import StandardScaler
    results: Dict[str, Dict[str, Dict]] = {}
    for ds_name, (X, y), k in make_datasets(n_samples):
        X = StandardScaler().fit_transform(X).astype(np.float32)
        results[ds_name] = {}
        algos = our_algorithms(k, dev)
        if include_sklearn:
            algos = algos + sklearn_algorithms(k)
        for name, fn in algos:
            t0 = time.perf_counter()
            labels = fn(X)
            dt = time.perf_counter() - t0
            entry = {"time_s": dt, "labels": np.asarray(labels)}
            if y is not None:
                from sklearn.metrics import adjusted_rand_score
                entry["ari"] = float(adjusted_rand_score(y, labels))
            results[ds_name][name] = entry
    return results


def plot_grid(results, path: str, n_samples: int = 500) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.preprocessing import StandardScaler

    datasets = make_datasets(n_samples)
    algo_names = list(next(iter(results.values())).keys())
    fig, axes = plt.subplots(len(datasets), len(algo_names),
                             figsize=(2.2 * len(algo_names),
                                      2.2 * len(datasets)))
    for i, (ds_name, (X, y), k) in enumerate(datasets):
        X = StandardScaler().fit_transform(X)
        for j, an in enumerate(algo_names):
            ax = axes[i][j]
            lab = results[ds_name][an]["labels"]
            ax.scatter(X[:, 0], X[:, 1], c=lab % 10, s=3, cmap="tab10")
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_title(an, fontsize=7)
            ax.text(0.02, 0.02, f"{results[ds_name][an]['time_s']*1e3:.0f}ms",
                    transform=ax.transAxes, fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--png", default=None)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--no-sklearn", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run the port on the CPU (default: cuda)")
    args = ap.parse_args(argv)
    res = run_comparison(args.n, include_sklearn=not args.no_sklearn,
                         device=args.device)
    for ds, algos in res.items():
        print(f"== {ds}")
        for name, e in algos.items():
            ari = f" ari={e['ari']:.3f}" if "ari" in e else ""
            print(f"  {name:20s} {e['time_s']*1e3:8.1f} ms{ari}")
    if args.png:
        plot_grid(res, args.png, args.n)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()

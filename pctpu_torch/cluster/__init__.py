"""Classical clustering (port of `pctpu/cluster`): k-means, Gaussian
mixtures, DBSCAN, spectral clustering and plane RANSAC, each with the
reference's shim class."""
from pctpu_torch.cluster.kmeans import kmeans, K_Means  # noqa: F401
from pctpu_torch.cluster.gmm import gmm_fit, gmm_predict, GMM, GMMState  # noqa: F401
from pctpu_torch.cluster.dbscan import dbscan, DBSCAN  # noqa: F401
from pctpu_torch.cluster.spectral import (  # noqa: F401
    spectral_clustering, spectral_embedding, spetral_clustering)
from pctpu_torch.cluster.plane_ransac import (  # noqa: F401
    plane_ransac, segment_ground, PlaneResult)

"""The plain reference the benchmark holds the program's outputs against.

Plain NumPy and PyTorch, written for the benchmark: it imports nothing of
the program and nothing of JAX, and takes nothing the program made. It
works out again, from the benchmark's own inputs, what a job produces:

* ``consensus``: the contingency table's label-merge grammar;
* ``de``: the fast-path Seurat gates and the all-pairs Wilcoxon rank-sum
  test (rank sums and tie moments as contractions over tied runs), BH
  and the DE call;
* ``embed``: the DE-gene union and its randomized-subspace PCA;
* ``ward``: exact Ward.D2 by rounds of reciprocal nearest neighbours on
  the device, written out as an hclust tree;
* ``treecut``: the dynamic hybrid tree cut (a copy of the JAX package's
  numpy algorithm, the semantics the port is held to);
* ``silhouette``: exact silhouettes from per-cluster distance sums;
* ``pool``: the pool branch past ``approx_threshold`` (seeded Lloyd,
  occupancy-weighted Ward.D2, the scaled cut, the pooled silhouette
  estimator) and the structure a pooled cut has.

Every device function takes a ``dtype``: float64 is the reference, and
float32 with TF32 matrix products (``precision(tf32=True)``) is the
control, the precision step below the port's float32 with TF32 off.
``judge`` compares an outcome with the reference and ``control`` builds
the control's outcome.
"""

r"""The port's kernels and the functions around them. Importing this package
registers every kernel entry point as a ``torch.library`` operator in the
``vp_suite_tpu_torch`` namespace (:mod:`~vp_suite_tpu_torch.ops.library`),
which is what a program exported by :mod:`vp_suite_tpu_torch.serving` needs
to load."""
from vp_suite_tpu_torch.ops import cells, convlstm, sym_eig, warp  # noqa: F401  (registers the operators)

"""repro_torch.forms — the FORMS compression API of the port.

:class:`FormsSpec`, :class:`FormsLinearParams` with :func:`from_dense` /
:func:`to_dense` / :func:`apply` / :func:`apply_simulated`, the ambient
:func:`default_spec` and :func:`sparsity_stats`, and whole-tree
:func:`compress_tree` / :func:`decompress_tree`, mirroring ``repro.forms``.
"""
from repro_torch.forms.linear import (FormsLinearParams, apply, apply_simulated,
                                      default_spec, from_dense, sparsity_stats,
                                      to_dense)
from repro_torch.forms.spec import FormsSpec, spec_from_meta
from repro_torch.forms.tree import (CompressReport, compress_tree,
                                    compressed_paths, decompress_tree,
                                    spec_for_path)

__all__ = [
    "FormsSpec", "spec_from_meta", "FormsLinearParams", "from_dense", "to_dense", "apply",
    "apply_simulated", "default_spec", "sparsity_stats", "compress_tree",
    "decompress_tree", "compressed_paths", "CompressReport", "spec_for_path",
]

"""repro_torch.forms — the FORMS compression API of the port.

:class:`FormsSpec`, :class:`FormsLinearParams` with :func:`from_dense` /
:func:`to_dense` / :func:`apply`, and whole-tree :func:`compress_tree` /
:func:`decompress_tree`, mirroring ``repro.forms``.
"""
from repro_torch.forms.linear import (FormsLinearParams, apply, default_spec,
                                      from_dense, to_dense)
from repro_torch.forms.spec import FormsSpec
from repro_torch.forms.tree import (CompressReport, compress_tree,
                                    compressed_paths, decompress_tree,
                                    spec_for_path)

__all__ = [
    "FormsSpec", "FormsLinearParams", "from_dense", "to_dense", "apply",
    "default_spec", "compress_tree", "decompress_tree", "compressed_paths",
    "CompressReport", "spec_for_path",
]

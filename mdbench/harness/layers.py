"""Kernel name -> layer, from ``layers/<layer>/*.txt``.

Each file lists kernel name fragments, one a line (``#`` starts a
comment).  A device operation belongs to the layer of the longest
fragment its name contains; one that matches none is engine-loop glue
(torch's own kernels, copies and fills).  A later change that adds a
kernel adds a file.
"""
from __future__ import annotations

import glob
import os

from .spec import HERE

GLUE = "glue"


def fragments(root: str = HERE) -> list:
    """[(fragment, layer)], longest fragment first."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "layers", "*", "*.txt"))):
        layer = os.path.basename(os.path.dirname(path))
        with open(path) as f:
            for line in f:
                frag = line.split("#")[0].strip()
                if frag:
                    out.append((frag, layer))
    return sorted(out, key=lambda fl: -len(fl[0]))


class LayerMap:
    def __init__(self, root: str = HERE):
        self.frags = fragments(root)
        self._memo = {}

    def __call__(self, name: str) -> str:
        layer = self._memo.get(name)
        if layer is None:
            layer = next((lay for frag, lay in self.frags if frag in name),
                         GLUE)
            self._memo[name] = layer
        return layer

"""Optional host libraries, imported where they are used.

OpenCV (image and video codecs, undistortion, the viewer's window) and
matplotlib (trajectory plots) are not dependencies of the port: the
card's machine may lack them, and the tracker never needs them. A
function that does raises an ``ImportError`` naming the library.
"""

from __future__ import annotations


def cv2(what: str):
    """The ``cv2`` module, for ``what``."""
    try:
        import cv2 as mod
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is not installed") from e
    return mod


def pyplot(what: str):
    """matplotlib's ``pyplot`` on the Agg backend, for ``what``."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

"""PDF -> page images for multimodal prompts (the port's copy of
aria_tpu/data/pdf.py).

The reference demonstrates multipage-PDF understanding in its cookbooks
(inference/notebooks/02_multi_page_pdf_understanding.ipynb) via pdf2image.
This loader tries the common rasterizer stacks in order and fails with an
actionable message when none is installed (this framework adds no hard
dependency on poppler):

1. pdf2image (poppler)           2. pypdfium2
3. `pdftoppm` CLI (poppler-utils)
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

from PIL import Image


def load_pdf_pages(path: str, dpi: int = 144, max_pages: Optional[int] = None) -> List[Image.Image]:
    """Rasterize a PDF into RGB PIL pages (one image per page)."""
    try:
        from pdf2image import convert_from_path  # type: ignore

        pages = convert_from_path(path, dpi=dpi)
        pages = [p.convert("RGB") for p in pages]
        return pages[:max_pages] if max_pages else pages
    except ImportError:
        pass

    try:
        import pypdfium2  # type: ignore

        doc = pypdfium2.PdfDocument(path)
        n = len(doc) if max_pages is None else min(len(doc), max_pages)
        return [
            doc[i].render(scale=dpi / 72.0).to_pil().convert("RGB") for i in range(n)
        ]
    except ImportError:
        pass

    if shutil.which("pdftoppm"):
        with tempfile.TemporaryDirectory() as d:
            cmd = ["pdftoppm", "-png", "-r", str(dpi)]
            if max_pages:
                cmd += ["-l", str(max_pages)]
            subprocess.run(cmd + [path, os.path.join(d, "page")], check=True)
            files = sorted(
                f for f in os.listdir(d) if f.startswith("page") and f.endswith(".png")
            )
            return [Image.open(os.path.join(d, f)).convert("RGB") for f in files]

    raise RuntimeError(
        "no PDF rasterizer available: install pdf2image (poppler), pypdfium2, "
        "or poppler-utils (pdftoppm)"
    )

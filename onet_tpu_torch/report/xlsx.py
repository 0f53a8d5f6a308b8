"""Minimal dependency-free .xlsx writer with embedded images
(``onet_tpu/report/xlsx.py``; the port keeps its own copy, as it imports
nothing of the JAX package).

The reference's headline ZY-3 deliverable is an Excel report with embedded
rgb/label/pred/Vt/Vd thumbnails per row (save_results_to_excel /
save_image_to_cell, uti_zy3_test_20240123.py:541-591), and no Excel engine
(openpyxl/xlsxwriter) is required here. An .xlsx file is a zip of OOXML
parts; this module writes exactly the parts needed:

* multiple worksheets with string / numeric cells (inline strings, no
  sharedStrings table),
* PNG images anchored to cells (oneCellAnchor drawings, pixel-sized;
  PIL encodes them),
* column widths / row heights so thumbnails are visible.

The output opens in Excel / LibreOffice / openpyxl.
"""

from __future__ import annotations

import io
import os
import re
import zipfile
from typing import List, Optional, Tuple, Union

import numpy as np

EMU_PER_PX = 9525  # 914400 EMU/inch at 96 px/inch


def col_letter(col: int) -> str:
    """1-based column index -> Excel letters (1 -> A, 27 -> AA)."""
    out = ""
    while col > 0:
        col, rem = divmod(col - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _png_bytes(img: Union[bytes, str, np.ndarray]) -> bytes:
    if isinstance(img, bytes):
        return img
    if isinstance(img, str):
        with open(img, "rb") as f:
            return f.read()
    from PIL import Image
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0.0, 1.0)
        a = (a * 255).astype(np.uint8)
    pil = Image.fromarray(a)           # 2-D uint8 -> mode L
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    return buf.getvalue()


class Worksheet:
    def __init__(self, name: str):
        if re.search(r"[\\/*?\[\]:]", name) or len(name) > 31:
            raise ValueError(f"invalid sheet name {name!r}")
        self.name = name
        self._cells = {}          # (row, col) -> value
        self._images: List[Tuple[bytes, int, int, int, int]] = []
        self._col_widths = {}     # col -> width (chars)
        self._row_heights = {}    # row -> height (points)

    def cell(self, row: int, col: int, value) -> None:
        """Set a cell (1-based row/col). Numbers stay numeric; everything
        else is written as an inline string."""
        self._cells[(row, col)] = value

    def write_row(self, row: int, values, start_col: int = 1) -> None:
        for j, v in enumerate(values):
            self.cell(row, start_col + j, v)

    def add_image(self, img: Union[bytes, str, np.ndarray], row: int,
                  col: int, width_px: int = 50, height_px: int = 50) -> None:
        """Anchor a PNG at a cell (1-based row/col), sized in pixels.
        ``img`` may be PNG bytes, a PNG path, or an HxW[x3] array
        (floats in [0,1] or uint8)."""
        self._images.append((_png_bytes(img), row, col, width_px, height_px))

    def set_column_width(self, col: int, width: float) -> None:
        self._col_widths[col] = width

    def set_row_height(self, row: int, height: float) -> None:
        self._row_heights[row] = height

    # -- XML emit ----------------------------------------------------------

    def _sheet_xml(self, drawing_rid: Optional[str]) -> str:
        parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
                 '<worksheet xmlns="http://schemas.openxmlformats.org/'
                 'spreadsheetml/2006/main" xmlns:r="http://schemas.'
                 'openxmlformats.org/officeDocument/2006/relationships">']
        if self._col_widths:
            parts.append("<cols>")
            for c, w in sorted(self._col_widths.items()):
                parts.append(f'<col min="{c}" max="{c}" width="{w}" '
                             'customWidth="1"/>')
            parts.append("</cols>")
        parts.append("<sheetData>")
        rows = sorted({r for r, _ in self._cells} | set(self._row_heights))
        for r in rows:
            attrs = f' ht="{self._row_heights[r]}" customHeight="1"' \
                if r in self._row_heights else ""
            parts.append(f'<row r="{r}"{attrs}>')
            cols = sorted(c for rr, c in self._cells if rr == r)
            for c in cols:
                v = self._cells[(r, c)]
                ref = f"{col_letter(c)}{r}"
                if isinstance(v, (bool, np.bool_)):
                    parts.append(f'<c r="{ref}" t="b"><v>{int(v)}</v></c>')
                elif isinstance(v, (int, float, np.integer, np.floating)):
                    if isinstance(v, (float, np.floating)) and not np.isfinite(v):
                        parts.append(f'<c r="{ref}" t="inlineStr"><is><t>'
                                     f'{_esc(repr(float(v)))}</t></is></c>')
                    else:
                        parts.append(f'<c r="{ref}"><v>{v!r}</v></c>')
                else:
                    parts.append(f'<c r="{ref}" t="inlineStr"><is><t>'
                                 f'{_esc(v)}</t></is></c>')
            parts.append("</row>")
        parts.append("</sheetData>")
        if drawing_rid:
            parts.append(f'<drawing r:id="{drawing_rid}"/>')
        parts.append("</worksheet>")
        return "".join(parts)

    def _drawing_xml(self, image_rids: List[str]) -> str:
        parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
                 '<xdr:wsDr xmlns:xdr="http://schemas.openxmlformats.org/'
                 'drawingml/2006/spreadsheetDrawing" xmlns:a="http://schemas.'
                 'openxmlformats.org/drawingml/2006/main" xmlns:r="http://'
                 'schemas.openxmlformats.org/officeDocument/2006/'
                 'relationships">']
        for i, ((_, row, col, wpx, hpx), rid) in enumerate(
                zip(self._images, image_rids), start=1):
            parts.append(
                "<xdr:oneCellAnchor>"
                f"<xdr:from><xdr:col>{col - 1}</xdr:col><xdr:colOff>0"
                f"</xdr:colOff><xdr:row>{row - 1}</xdr:row><xdr:rowOff>0"
                "</xdr:rowOff></xdr:from>"
                f'<xdr:ext cx="{wpx * EMU_PER_PX}" cy="{hpx * EMU_PER_PX}"/>'
                "<xdr:pic><xdr:nvPicPr>"
                f'<xdr:cNvPr id="{i}" name="img{i}"/>'
                '<xdr:cNvPicPr/></xdr:nvPicPr><xdr:blipFill>'
                f'<a:blip r:embed="{rid}"/><a:stretch><a:fillRect/>'
                "</a:stretch></xdr:blipFill><xdr:spPr><a:prstGeom "
                'prst="rect"><a:avLst/></a:prstGeom></xdr:spPr></xdr:pic>'
                "<xdr:clientData/></xdr:oneCellAnchor>")
        parts.append("</xdr:wsDr>")
        return "".join(parts)


_RELS_NS = "http://schemas.openxmlformats.org/package/2006/relationships"
_DOC_REL = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"


class Workbook:
    def __init__(self):
        self.sheets: List[Worksheet] = []

    def add_sheet(self, name: str) -> Worksheet:
        ws = Worksheet(name)
        self.sheets.append(ws)
        return ws

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = len(self.sheets)
        if n == 0:
            self.add_sheet("Sheet1")
            n = 1
        media = []       # (filename, bytes)
        overrides = []
        z = zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED)
        try:
            # workbook + workbook rels
            sheet_tags = "".join(
                f'<sheet name="{_esc(ws.name)}" sheetId="{i}" r:id="rIdS{i}"/>'
                for i, ws in enumerate(self.sheets, start=1))
            z.writestr("xl/workbook.xml",
                       '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                       '<workbook xmlns="http://schemas.openxmlformats.org/'
                       'spreadsheetml/2006/main" xmlns:r="' + _DOC_REL + '">'
                       f"<sheets>{sheet_tags}</sheets></workbook>")
            wb_rels = "".join(
                f'<Relationship Id="rIdS{i}" Type="{_DOC_REL}/worksheet" '
                f'Target="worksheets/sheet{i}.xml"/>'
                for i in range(1, n + 1))
            wb_rels += (f'<Relationship Id="rIdStyles" Type="{_DOC_REL}'
                        '/styles" Target="styles.xml"/>')
            z.writestr("xl/_rels/workbook.xml.rels",
                       f'<?xml version="1.0" encoding="UTF-8" standalone='
                       f'"yes"?><Relationships xmlns="{_RELS_NS}">'
                       f"{wb_rels}</Relationships>")
            z.writestr("xl/styles.xml",
                       '<?xml version="1.0" encoding="UTF-8" standalone='
                       '"yes"?><styleSheet xmlns="http://schemas.'
                       'openxmlformats.org/spreadsheetml/2006/main">'
                       '<fonts count="1"><font><sz val="11"/><name val='
                       '"Calibri"/></font></fonts>'
                       '<fills count="1"><fill><patternFill patternType='
                       '"none"/></fill></fills>'
                       '<borders count="1"><border/></borders>'
                       '<cellStyleXfs count="1"><xf/></cellStyleXfs>'
                       '<cellXfs count="1"><xf/></cellXfs></styleSheet>')
            drawing_no = 0
            for i, ws in enumerate(self.sheets, start=1):
                drawing_rid = None
                if ws._images:
                    drawing_no += 1
                    rids = []
                    rels = []
                    for j, (png, *_rest) in enumerate(ws._images, start=1):
                        img_name = f"image{len(media) + 1}.png"
                        media.append((img_name, png))
                        rid = f"rIdI{j}"
                        rids.append(rid)
                        rels.append(
                            f'<Relationship Id="{rid}" Type="{_DOC_REL}'
                            f'/image" Target="../media/{img_name}"/>')
                    z.writestr(f"xl/drawings/drawing{drawing_no}.xml",
                               ws._drawing_xml(rids))
                    z.writestr(
                        f"xl/drawings/_rels/drawing{drawing_no}.xml.rels",
                        f'<?xml version="1.0" encoding="UTF-8" standalone='
                        f'"yes"?><Relationships xmlns="{_RELS_NS}">'
                        f'{"".join(rels)}</Relationships>')
                    drawing_rid = "rIdD1"
                    z.writestr(
                        f"xl/worksheets/_rels/sheet{i}.xml.rels",
                        f'<?xml version="1.0" encoding="UTF-8" standalone='
                        f'"yes"?><Relationships xmlns="{_RELS_NS}">'
                        f'<Relationship Id="rIdD1" Type="{_DOC_REL}/drawing" '
                        f'Target="../drawings/drawing{drawing_no}.xml"/>'
                        '</Relationships>')
                    overrides.append(
                        f'<Override PartName="/xl/drawings/drawing'
                        f'{drawing_no}.xml" ContentType="application/vnd.'
                        'openxmlformats-officedocument.drawing+xml"/>')
                z.writestr(f"xl/worksheets/sheet{i}.xml",
                           ws._sheet_xml(drawing_rid))
                overrides.append(
                    f'<Override PartName="/xl/worksheets/sheet{i}.xml" '
                    'ContentType="application/vnd.openxmlformats-'
                    'officedocument.spreadsheetml.worksheet+xml"/>')
            for img_name, png in media:
                z.writestr(f"xl/media/{img_name}", png)
            z.writestr("_rels/.rels",
                       f'<?xml version="1.0" encoding="UTF-8" standalone='
                       f'"yes"?><Relationships xmlns="{_RELS_NS}">'
                       f'<Relationship Id="rId1" Type="{_DOC_REL}'
                       '/officeDocument" Target="xl/workbook.xml"/>'
                       "</Relationships>")
            z.writestr("[Content_Types].xml",
                       '<?xml version="1.0" encoding="UTF-8" standalone='
                       '"yes"?><Types xmlns="http://schemas.openxmlformats.'
                       'org/package/2006/content-types">'
                       '<Default Extension="rels" ContentType="application/'
                       'vnd.openxmlformats-package.relationships+xml"/>'
                       '<Default Extension="xml" ContentType="application/'
                       'xml"/>'
                       '<Default Extension="png" ContentType="image/png"/>'
                       '<Override PartName="/xl/workbook.xml" ContentType='
                       '"application/vnd.openxmlformats-officedocument.'
                       'spreadsheetml.sheet.main+xml"/>'
                       '<Override PartName="/xl/styles.xml" ContentType='
                       '"application/vnd.openxmlformats-officedocument.'
                       'spreadsheetml.styles+xml"/>'
                       + "".join(overrides) + "</Types>")
        finally:
            z.close()
        return path

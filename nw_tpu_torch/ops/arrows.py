"""Tie-mask bits: the port's copy of ``nw_tpu/ops/arrows.py``.

A cell's complete walk information is one ``uint8`` bit mask, in place
of the reference's 32-byte walk-table cell (``walk-table.h:48-57``):

* bit 0 (``ARROW_DIAG``): the diagonal predecessor is optimal
  (reference ``walk_table_cell_t.diag``, set at needleman-wunsch.c:486-488)
* bit 1 (``ARROW_LEFT``): the left predecessor is optimal (``.left``, :498-500)
* bit 2 (``ARROW_UP``): the up predecessor is optimal (``.up``, :492-494)

Boundary cells carry exactly the reference's seeded arrows
(computation.c:96-120): row 0 cells (i>=1) = ``ARROW_LEFT``, column 0
cells (j>=1) = ``ARROW_UP``, cell (0,0) = 0.  Every mask table of this
package (``nw_fill_masks``, ``nw_fill_masks_batch``, ``nw_fill_tile``'s
masks mode and their plain versions) uses these bits.
"""

import numpy as np

ARROW_DIAG = np.uint8(1)
ARROW_LEFT = np.uint8(2)
ARROW_UP = np.uint8(4)

ARROW_DTYPE = np.uint8

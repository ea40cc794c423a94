"""Objects365 -> COCO classifier-head remap (the port's own copy of
`lwdetr_tpu/utils/obj365_remap.py`).

When fine-tuning a COCO model from an Objects365 pretrain, the 366-way
classifier rows of the 80 classes shared between the datasets are copied
into the 91-way COCO head (reference util/obj365_to_coco_model.py:81-102;
applied to the keys listed in --pretrain_keys_modify_to_load,
main.py:248-255).  The id tables are the datasets' category indices.
"""
from __future__ import annotations

import numpy as np

# COCO category ids of the 80 classes (row indices in the 91-way head)
COCO_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
    89, 90,
]
# matching Objects365 class indices (0-based; +1 offset in the 366-way head)
OBJ365_IDS = [
    0, 46, 5, 58, 114, 55, 116, 65, 21, 40, 176, 127, 249, 24, 56, 139, 92, 78,
    99, 96, 144, 295, 178, 180, 38, 39, 13, 43, 120, 219, 148, 173, 165, 154,
    137, 113, 145, 146, 204, 8, 35, 10, 88, 84, 93, 26, 112, 82, 265, 104, 141,
    152, 234, 143, 150, 97, 2, 50, 25, 75, 98, 153, 37, 73, 115, 132, 106, 61,
    163, 134, 277, 81, 133, 18, 94, 30, 169, 70, 328, 226,
]


def coco_rows_from_obj365(cur: np.ndarray, pretrain: np.ndarray) -> np.ndarray:
    """Copy the 80 shared-class rows of a (366, ...) o365 head into a
    (91, ...) COCO head (torch row-major layout: rows = classes)."""
    if pretrain.shape == cur.shape:
        return pretrain.copy()
    out = cur.copy()
    for coco_id, obj_id in zip(COCO_IDS, OBJ365_IDS):
        out[coco_id] = pretrain[obj_id + 1]
    return out


def remap_torch_state_dict(cur_sd: dict, pretrain_sd: dict,
                           keys_to_modify) -> dict:
    """Apply the head remap to selected keys of a torch-layout state_dict
    (reference main.py:240-259). Returns the pretrain_sd with remapped keys."""
    out = dict(pretrain_sd)
    for k in keys_to_modify or []:
        if k in pretrain_sd and k in cur_sd:
            out[k] = coco_rows_from_obj365(
                np.asarray(cur_sd[k]), np.asarray(pretrain_sd[k]))
    return out

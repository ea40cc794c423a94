"""Data pipeline: COCO-format datasets, transforms, the batch loader and the COCO evaluator."""

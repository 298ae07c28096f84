"""Offline scene-geometry tools: known-pose SfM triangulation and
mask->point-cloud object tagging (the pseudo-label steps that produce the
`colmap-*.ply` static cloud and the per-point `obj` ids `data/readers.py`
consumes); counterpart of adgs_tpu/geometry, whose array work runs here
on a torch device."""

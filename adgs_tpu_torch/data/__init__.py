"""Scene data: PLY and COLMAP files, scene readers, frame loading."""

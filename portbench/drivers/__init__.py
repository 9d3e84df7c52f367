"""One driver per kind of mix (the ``kind`` of a file under ``traffic/``):
set-up, the measured window and the check of its outputs."""

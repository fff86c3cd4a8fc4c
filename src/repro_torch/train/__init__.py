"""Detector training: the loop (``trainer``) and the end-to-end run
(``detector``)."""

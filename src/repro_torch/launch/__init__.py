"""Launch-side models of the card (``roofline``), meshes (``mesh``) and
the entry points (``serve``, ``train``)."""

"""Launch-side models of the card (``roofline``)."""

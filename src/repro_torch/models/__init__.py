"""Models; only the toy MLP classifier is ported so far."""

"""Entry points of the port: the k-search, LM serving and LM training launchers."""

"""Entry points of the port: the k-search and LM serving launchers."""

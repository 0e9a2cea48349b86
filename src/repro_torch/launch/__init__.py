"""Entry points of the port: the k-search driver."""

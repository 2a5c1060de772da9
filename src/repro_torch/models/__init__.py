"""Models of the port: the dense decoder's paged serve path."""

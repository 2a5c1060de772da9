"""Models of the port: the dense decoder (training forward and the paged
serve path) and the classic-RL Gaussian MLP actor-critic."""

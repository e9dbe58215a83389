"""HTTP serving of the port: the prediction server."""

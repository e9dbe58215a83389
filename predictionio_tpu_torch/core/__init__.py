"""DASE core of the port: engine context, components, engines, persistence."""

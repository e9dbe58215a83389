"""DASE core of the port: engine context, components, engines, the train
workflow, warm starts, persistence."""

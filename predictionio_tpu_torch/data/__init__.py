"""Data layer of the port: events, id vocabularies, storage and the event
store facade."""

from predictionio_tpu_torch.data.datamap import DataMap, DataMapError, PropertyMap
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    validate_event,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.aggregator import (
    aggregate_properties,
    aggregate_properties_single,
)

__all__ = [
    "BiMap",
    "DataMap",
    "DataMapError",
    "Event",
    "EventValidationError",
    "PropertyMap",
    "aggregate_properties",
    "aggregate_properties_single",
    "validate_event",
]

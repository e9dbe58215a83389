"""Data layer of the port: events, id vocabularies, storage and the event
store facade."""

"""Data layer of the port: id vocabularies and storage."""

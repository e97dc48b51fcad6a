"""Scene ingestion of the port (this slice: the MDL material loader)."""

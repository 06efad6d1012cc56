"""Host-side data pipeline of the port: datasets, molding, batches."""

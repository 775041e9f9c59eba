"""Device lanes for the multi-device engines (``context.make_data_devices``)."""

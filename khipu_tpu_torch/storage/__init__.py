"""Storage: the DataSource SPI, the memory engine, node stores with
their reorg ring and read cache, the app state, the ``Storages``
façade, the device node mirror and the compactor."""

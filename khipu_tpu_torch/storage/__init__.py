"""Storage: the DataSource SPI, the memory and sqlite engines (the
native append-log engine is ``native/store.py``), node stores with their
reorg ring and read cache, the app state, the ``Storages`` façade, the
device node mirror and the compactor."""

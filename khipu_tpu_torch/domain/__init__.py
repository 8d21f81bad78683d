"""Domain types: accounts, headers, transactions, receipts, blocks, the
chain facade (khipu-eth/src/main/scala/khipu/domain/). Import the
submodules directly: ``transaction`` imports ``evm.dataword`` while
``evm.vm`` imports domain types, so an eager re-export here would be a
cycle."""

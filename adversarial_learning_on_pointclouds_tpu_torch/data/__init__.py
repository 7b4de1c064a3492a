"""Data layer: ModelNet40 and ShapeNet-part readers and fixtures, the
native loader, index streams and the device stage, augmentation on the
device.

``modelnet40`` (``ModelNet40``, the h5 shards, ``h5py`` inside the
reader only; ``synthetic_modelnet``, the JAX package's fixture in
memory), ``shapenet_part`` (``ShapeNetPart``, ``make_synthetic_shapenet``, pts
layout by default, ``h5py`` only for the h5 layout), ``native_loader``
(the C++ ``.pts`` reader of ``native/``, with its numpy path),
``loader`` (``host_index_iterator``, ``cycling_host_indices``,
``host_batch_iterator``, ``cycling_host_batches``, ``device_batches``,
``batch_iterator``) and ``augment``. Only numpy and torch are imported.
"""

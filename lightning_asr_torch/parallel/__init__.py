"""Process parallelism: the process group with its data and model groups
(``distributed``), the row layout of a global batch over a data group
(``mesh``), and tensor parallelism, the conv trunk's channels split over a
model group (``tp``)."""

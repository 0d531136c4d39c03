"""MNIST models (a copy of ``cxxnet_tpu/models/mnist.py``): the nets of
the reference cxxnet's ``example/MNIST/MNIST.conf`` and
``MNIST_CONV.conf``, as config text."""


def mnist_mlp(nhidden: int = 100, nclass: int = 10,
              batch_size: int = 100) -> str:
    """2-layer MLP: the reference's MNIST.conf net (~98% target)."""
    return """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = %d
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = %d
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = %d
eta = 0.1
momentum = 0.9
wd = 0.0
metric[label] = error
""" % (nhidden, nclass, batch_size)


def mnist_conv(nclass: int = 10, batch_size: int = 100) -> str:
    """Small convnet: the reference's MNIST_CONV.conf net (~99% target)."""
    return """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  stride = 2
  nchannel = 32
  random_type = xavier
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = flatten
layer[3->3] = dropout
  threshold = 0.5
layer[3->4] = fullc:fc1
  nhidden = 100
  init_sigma = 0.01
layer[4->5] = sigmoid:se1
layer[5->6] = fullc:fc2
  nhidden = %d
  init_sigma = 0.01
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = %d
eta = 0.1
momentum = 0.9
wd = 0.0
metric = error
""" % (nclass, batch_size)

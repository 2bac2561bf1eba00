"""The port's model zoo, under the reference's names
(``paddle_tpu/models/__init__.py``): the book's models, BERT, GPT, the
Transformer, DeepFM, and the CV zoo (classifiers, video, OCR, DCGAN and
the SSD, YOLOv3 and Faster/Mask R-CNN detectors). Importing the package
imports torch only."""

from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertModel)
from paddle_tpu_torch.models.book import (LinearRegression,
                                          MachineTranslation,
                                          RecommenderSystem, RNNLanguageModel,
                                          SentimentCNN, SentimentLSTM,
                                          SkipGramNS, Word2Vec)
from paddle_tpu_torch.models.convert import gpt_state_from_jax, state_from_jax
from paddle_tpu_torch.models.deepfm import DeepFM
from paddle_tpu_torch.models.faster_rcnn import (FasterRCNN,
                                                 FasterRCNNConfig, MaskRCNN)
from paddle_tpu_torch.models.gan import (DCGANDiscriminator, DCGANGenerator,
                                         gan_step)
from paddle_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from paddle_tpu_torch.models.legacy_cv import (AlexNet, DarkNet53,
                                               DenseNet121, GoogLeNet,
                                               ShuffleNetV2, SqueezeNet)
from paddle_tpu_torch.models.lenet import LeNet
from paddle_tpu_torch.models.mobilenet import MobileNetV1, MobileNetV2
from paddle_tpu_torch.models.ocr import CRNN
from paddle_tpu_torch.models.resnet import ResNet, ResNet50
from paddle_tpu_torch.models.se_resnext import SEResNeXt, SEResNeXt50
from paddle_tpu_torch.models.ssd import SSD, SSDConfig
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig
from paddle_tpu_torch.models.vgg import VGG, VGG16
from paddle_tpu_torch.models.video import C3D, TSN
from paddle_tpu_torch.models.yolov3 import YOLOv3, YOLOv3Config

__all__ = ["LeNet", "BertConfig", "BertModel", "BertForPretraining",
           "ResNet", "ResNet50", "DeepFM", "Transformer",
           "TransformerConfig", "GPT", "GPTBlock", "GPTConfig",
           "LinearRegression", "MachineTranslation", "RNNLanguageModel",
           "SentimentCNN", "SentimentLSTM", "SkipGramNS", "Word2Vec",
           "RecommenderSystem", "MobileNetV1", "MobileNetV2", "VGG", "VGG16",
           "SEResNeXt", "SEResNeXt50", "AlexNet", "DarkNet53", "DenseNet121",
           "GoogLeNet", "ShuffleNetV2", "SqueezeNet", "SSD", "SSDConfig",
           "FasterRCNN", "FasterRCNNConfig", "MaskRCNN", "C3D", "TSN",
           "YOLOv3", "YOLOv3Config", "CRNN", "DCGANGenerator",
           "DCGANDiscriminator", "gan_step", "gpt_state_from_jax",
           "state_from_jax"]

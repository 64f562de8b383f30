// The bitstreams of WebP files for `vision_tpu_torch/scene/webp.py`:
// lossless VP8L images (RFC 9649), the ALPH chunk (raw or VP8L-coded
// alpha, its four filters) and lossy VP8 key frames (RFC 6386). Each is
// decoded as libwebp 1.x decodes it (src/dec/vp8l_dec.c, alpha_dec.c,
// vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c; src/dsp/dec.c,
// lossless.c, filters.c, upsampling.c, yuv.h; src/utils/huffman_utils.c,
// bit_reader_utils.c), bit for bit: the same bit readers with the same
// end-of-data rules, the same Huffman table checks, the same integer
// transforms, prediction edges, loop filters, "fancy" chroma upsampling and
// YUV -> RGB arithmetic. The RIFF container is parsed in Python.
//
// Each entry point returns 0, or a negative code where libwebp fails the
// decode. `vt_webp_coverage` reads (and optionally clears) counters of the
// paths taken, for the tests.
//
// C ABI, bound with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// RFC 6386 13.4: the probabilities of a coefficient probability update,
// [type][band][context][node]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 13.5: the default coefficient probabilities
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 11.5: the key frame's 4x4 mode probabilities, [above][left]
// [node], in this file's mode order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// RFC 6386 14.1: the quantiser step of each index
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// RFC 9649 4.2.2: the 120 short distance codes, (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------------------
// Path counters (vt_webp_coverage)
// ---------------------------------------------------------------------------

enum Cov {
  kCovI16 = 0,          // 4: 16x16 luma modes DC, TM, V, H
  kCovI4 = 4,           // 10: 4x4 modes DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
  kCovUV = 14,          // 4: chroma modes DC, TM, V, H
  kCovFilter = 18,      // 3: frames with no, the simple, the normal loop filter
  kCovSharp = 21,       // frames with sharpness > 0
  kCovParts = 22,       // 4: frames of 1, 2, 4, 8 token partitions
  kCovSegments = 26,    // frames with segments
  kCovLfDelta = 27,     // frames with loop-filter deltas
  kCovSkip = 28,        // frames with a skip probability
  kCovAlphFilter = 29,  // 4: ALPH filters none, horizontal, vertical, gradient
  kCovAlphMethod = 33,  // 2: ALPH raw, VP8L-coded
  kCovAlph8b = 35,      // VP8L-coded ALPH decoded a byte a pixel
  kCovTransform = 36,   // 4: predictor, cross-colour, subtract-green, colour-indexing
  kCovSimpleCode = 40,  // simple prefix codes
  kCovNormalCode = 41,  // normal prefix codes
  kCovCache = 42,       // images with a colour cache
  kCovMeta = 43,        // images with an entropy image (meta prefix codes)
  kCovBackRef = 44,     // LZ77 backward references
  kCovCacheHit = 45,    // colour-cache symbols
  kCovPredMode = 46,    // 16: tiles of predictor modes 0-15
  kCovBundle = 62,      // 4: colour-indexing transforms of 0-3 bundling bits
  kCovCount = 66
};
int64_t g_cov[kCovCount];
inline void cov(int i, int64_t n = 1) { g_cov[i] += n; }

// ---------------------------------------------------------------------------
// VP8L: the bit reader (bit_reader_utils.c), read least significant bit
// first through a 64-bit window
// ---------------------------------------------------------------------------

struct LBitReader {
  uint64_t val = 0;
  const uint8_t *buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t *start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    const size_t n = length > 8 ? 8 : length;
    for (size_t i = 0; i < n; ++i) val |= uint64_t(start[i]) << (8 * i);
    pos = n;
    buf = start;
  }
  // libwebp's end of stream: every byte in the window and more than its 64
  // bits consumed (so up to 64 bits of zeros may be read past a short
  // stream's end)
  bool end_of_stream() const { return eos || (pos == len && bit_pos > 64); }
  void set_end_of_stream() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (end_of_stream()) set_end_of_stream();
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end_of_stream();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
};

// ---------------------------------------------------------------------------
// VP8L: prefix codes (huffman_utils.c): a root table of 8 bits (7 for the
// code-length code) and second-level tables for the longer codes
// ---------------------------------------------------------------------------

struct HCode {
  uint8_t bits;
  uint16_t value;
};

const int kMaxCodeLength = 15;
const int kTableBits = 8;
const int kLengthsTableBits = 7;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode *table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int *count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// BuildHuffmanTable: 0 for a code libwebp refuses (no symbol, too many codes
// of a length, an over-subscribed or incomplete tree; one symbol alone is a
// code of no bits), else the table's size. With root == nullptr it only
// checks; `cap` bounds the table written.
int build_table(HCode *root, int cap, int root_bits, const int *lengths,
                int n, uint16_t *sorted) {
  HCode *table = root;
  int total = 1 << root_bits;
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  for (int s = 0; s < n; ++s) {
    const int l = lengths[s];
    if (l > 0) {
      if (sorted != nullptr) {
        sorted[offset[l]++] = uint16_t(s);
      } else {
        offset[l]++;
      }
    }
  }
  if (offset[kMaxCodeLength] == 1) {
    if (sorted != nullptr) {
      HCode c;
      c.bits = 0;
      c.value = sorted[0];
      replicate(table, 1, total, c);
    }
    return total;
  }
  uint32_t low = 0xffffffffu;
  const uint32_t mask = uint32_t(total - 1);
  uint32_t key = 0;
  int num_nodes = 1, num_open = 1;
  int table_bits = root_bits, table_size = 1 << table_bits;
  int symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (root == nullptr) continue;
    for (; count[len] > 0; --count[len]) {
      HCode c;
      c.bits = uint8_t(len);
      c.value = sorted[symbol++];
      replicate(&table[key], step, table_size, c);
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength;
       ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root != nullptr) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        low = key & mask;
        if (root != nullptr) {
          if ((table - root) + table_size > cap) return 0;
          root[low].bits = uint8_t(table_bits + root_bits);
          root[low].value = uint16_t((table - root) - low);
        }
      }
      if (root != nullptr) {
        HCode c;
        c.bits = uint8_t(len - root_bits);
        c.value = sorted[symbol++];
        replicate(&table[key >> root_bits], step, table_size, c);
      }
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total;
}

// VP8LBuildHuffmanTable into `store`: the table's offset, or -1 for a code
// libwebp refuses; store == nullptr checks only.
int64_t build_huffman(std::vector<HCode> *store, int root_bits,
                      const int *lengths, int n) {
  const int total = build_table(nullptr, 0, root_bits, lengths, n, nullptr);
  if (total == 0) return -1;
  if (store == nullptr) return 0;
  const size_t base = store->size();
  store->resize(base + total);
  std::vector<uint16_t> sorted(n);
  if (build_table(store->data() + base, total, root_bits, lengths, n,
                  sorted.data()) != total)
    return -1;
  return int64_t(base);
}

inline int read_symbol(const HCode *table, LBitReader &br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  const int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.bit_pos += kTableBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

// ---------------------------------------------------------------------------
// VP8L: the decoder (vp8l_dec.c)
// ---------------------------------------------------------------------------

const int kNumLiteralCodes = 256;
const int kNumLengthCodes = 24;
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256,
                              256, 40};
const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kCodeLengthExtraBits[3] = {2, 3, 7};
const int kCodeLengthRepeatOffsets[3] = {3, 3, 11};
const int kMaxCacheBits = 11;
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct HTreeGroup {
  int64_t htrees[5];
};

struct Meta {  // VP8LMetadata
  int cache_bits = 0;
  std::vector<uint32_t> cache;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<HTreeGroup> groups;
  std::vector<HCode> tables;
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct LDec {
  LBitReader br;
  unsigned seen = 0;
  std::vector<Transform> transforms;
  int width = 0, height = 0;  // of the coded (transformed) image
};

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

bool decode_image_stream(LDec &d, int xsize, int ysize, bool level0,
                         Meta &hdr, std::vector<uint32_t> *out);

bool read_code_lengths(LDec &d, const int *cl_lengths, int num_symbols,
                       int *code_lengths) {
  LBitReader &br = d.br;
  HCode table[1 << kLengthsTableBits];
  uint16_t sorted[19];
  if (build_table(nullptr, 0, kLengthsTableBits, cl_lengths, 19, nullptr) == 0)
    return false;
  build_table(table, 1 << kLengthsTableBits, kLengthsTableBits, cl_lengths,
              19, sorted);
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(length_nbits));
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode &p = table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
    br.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      code_lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      const int slot = code_len - 16;
      int repeat = int(br.read(kCodeLengthExtraBits[slot])) +
                   kCodeLengthRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = code_len == 16 ? prev : 0;
      while (repeat-- > 0) code_lengths[symbol++] = length;
    }
  }
  return true;
}

// ReadHuffmanCode: the table's offset in `tables` (nullptr: check only), or
// -1 where libwebp refuses the code
int64_t read_huffman_code(LDec &d, int alphabet_size, int *code_lengths,
                          std::vector<HCode> *tables) {
  LBitReader &br = d.br;
  const int simple = br.read(1);
  std::memset(code_lengths, 0, sizeof(int) * alphabet_size);
  bool ok;
  if (simple) {
    cov(kCovSimpleCode);
    const int num_symbols = int(br.read(1)) + 1;
    const int first_len = br.read(1);
    int symbol = br.read(first_len == 0 ? 1 : 8);
    code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br.read(8);
      code_lengths[symbol] = 1;
    }
    ok = true;
  } else {
    cov(kCovNormalCode);
    int cl_lengths[19] = {0};
    const int num_codes = int(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
    ok = read_code_lengths(d, cl_lengths, alphabet_size, code_lengths);
  }
  ok = ok && !br.eos;
  if (!ok) return -1;
  return build_huffman(tables, kTableBits, code_lengths, alphabet_size);
}

bool read_huffman_codes(LDec &d, Meta &hdr, int xsize, int ysize,
                        int cache_bits, bool allow_recursion) {
  LBitReader &br = d.br;
  int num_groups = 1, num_groups_max = 1;
  std::vector<int> mapping;
  if (allow_recursion && br.read(1)) {
    const int precision = 2 + int(br.read(3));
    const int hx = sub_sample(xsize, precision);
    const int hy = sub_sample(ysize, precision);
    Meta sub;
    if (!decode_image_stream(d, hx, hy, false, sub, &hdr.huffman_image))
      return false;
    cov(kCovMeta);
    hdr.huffman_bits = precision;
    for (auto &px : hdr.huffman_image) {
      const int group = int((px >> 8) & 0xffff);
      px = uint32_t(group);
      if (group >= num_groups_max) num_groups_max = group + 1;
    }
    if (num_groups_max > 1000 || int64_t(num_groups_max) > int64_t(xsize) * ysize) {
      mapping.assign(num_groups_max, -1);
      num_groups = 0;
      for (auto &px : hdr.huffman_image) {
        int &m = mapping[px];
        if (m == -1) m = num_groups++;
        px = uint32_t(m);
      }
    } else {
      num_groups = num_groups_max;
    }
  }
  if (br.eos) return false;
  const int max_alphabet = kAlphabetSize[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
  std::vector<int> code_lengths(max_alphabet);
  hdr.groups.assign(num_groups, HTreeGroup());
  for (int i = 0; i < num_groups_max; ++i) {
    const bool unused = !mapping.empty() && mapping[i] == -1;
    HTreeGroup *g = unused ? nullptr
                           : &hdr.groups[mapping.empty() ? i : mapping[i]];
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      const int64_t off = read_huffman_code(d, alphabet, code_lengths.data(),
                                            unused ? nullptr : &hdr.tables);
      if (off < 0) return false;
      if (g != nullptr) g->htrees[j] = off;
    }
  }
  return true;
}

bool read_transform(LDec &d, int *xsize, int *ysize) {
  LBitReader &br = d.br;
  const int type = br.read(2);
  if (d.seen & (1u << type)) return false;  // each transform at most once
  d.seen |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = *ysize;
  bool ok = true;
  cov(kCovTransform + type);
  if (type == PREDICTOR || type == CROSS_COLOR) {
    t.bits = int(br.read(3)) + 2;
    Meta sub;
    ok = decode_image_stream(d, sub_sample(t.xsize, t.bits),
                             sub_sample(t.ysize, t.bits), false, sub, &t.data);
  } else if (type == COLOR_INDEXING) {
    const int num_colors = int(br.read(8)) + 1;
    const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    *xsize = sub_sample(t.xsize, bits);
    t.bits = bits;
    cov(kCovBundle + bits);
    Meta sub;
    ok = decode_image_stream(d, num_colors, 1, false, sub, &t.data);
    if (ok) {  // ExpandColorMap: deltas summed a byte at a time, zeros after
      const int final_num = 1 << (8 >> bits);
      std::vector<uint32_t> map(final_num, 0);
      const uint8_t *src = reinterpret_cast<const uint8_t *>(t.data.data());
      uint8_t *dst = reinterpret_cast<uint8_t *>(map.data());
      for (int i = 0; i < 4; ++i) dst[i] = src[i];
      for (int i = 4; i < 4 * num_colors; ++i)
        dst[i] = uint8_t(src[i] + dst[i - 4]);
      t.data.swap(map);
    }
  }
  d.transforms.push_back(std::move(t));
  return ok;
}

inline const HTreeGroup &group_at(const Meta &hdr, int x, int y) {
  if (hdr.huffman_bits == 0) return hdr.groups[0];
  return hdr.groups[hdr.huffman_image[size_t(hdr.huffman_xsize) *
                                          (y >> hdr.huffman_bits) +
                                      (x >> hdr.huffman_bits)]];
}

inline int copy_distance(int symbol, LBitReader &br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

inline uint32_t hash_pix(uint32_t argb, int shift) {
  return (argb * 0x1e35a7bdu) >> shift;
}

// DecodeImageData: the prefix-coded, LZ77 and colour-cache coded pixels of
// an image of width x height; false where libwebp fails (a copy outside
// the image, or data past the stream's end)
bool decode_image_data(LDec &d, Meta &hdr, uint32_t *data, int width,
                       int height) {
  LBitReader &br = d.br;
  const size_t end = size_t(width) * height;
  size_t pos = 0, last_cached = 0;
  int col = 0, row = 0;
  const int cache_size = int(hdr.cache.size());
  const int shift = 32 - hdr.cache_bits;
  const int len_limit = kNumLiteralCodes + kNumLengthCodes;
  const int cache_limit = len_limit + cache_size;
  const HCode *T = hdr.tables.data();
  auto flush_cache = [&]() {
    if (cache_size > 0)
      while (last_cached < pos) {
        const uint32_t p = data[last_cached++];
        hdr.cache[hash_pix(p, shift)] = p;
      }
  };
  while (pos < end) {
    const HTreeGroup &g = group_at(hdr, col, row);
    br.fill();
    const int code = read_symbol(T + g.htrees[GREEN], br);
    if (br.end_of_stream()) break;
    if (code < kNumLiteralCodes) {
      const int red = read_symbol(T + g.htrees[RED], br);
      br.fill();
      const int blue = read_symbol(T + g.htrees[BLUE], br);
      const int alpha = read_symbol(T + g.htrees[ALPHA], br);
      if (br.end_of_stream()) break;
      data[pos] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                  (uint32_t(code) << 8) | uint32_t(blue);
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        flush_cache();
      }
    } else if (code < len_limit) {
      const int length = copy_distance(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(T + g.htrees[DIST], br);
      br.fill();
      const int dist_code = copy_distance(dist_symbol, br);
      const int dist = plane_code_to_distance(width, dist_code);
      if (br.end_of_stream()) break;
      if (pos < size_t(dist) || end - pos < size_t(length)) return false;
      cov(kCovBackRef);
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      flush_cache();
    } else if (code < cache_limit) {
      cov(kCovCacheHit);
      flush_cache();
      data[pos] = hdr.cache[code - len_limit];
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        flush_cache();
      }
    } else {
      return false;
    }
  }
  br.eos = br.end_of_stream();
  return !br.eos;
}

// DecodeAlphaData: an ALPH image coded with the colour-indexing transform
// alone and no colour cache, a byte a pixel; unlike decode_image_data, a
// stream that ends past its data after the last pixel is accepted
bool decode_alpha_8b(LDec &d, Meta &hdr, uint8_t *data, int width,
                     int height) {
  LBitReader &br = d.br;
  const size_t end = size_t(width) * height;
  size_t pos = 0;
  int col = 0, row = 0;
  bool ok = true;
  const HCode *T = hdr.tables.data();
  while (!br.eos && pos < end) {
    const HTreeGroup &g = group_at(hdr, col, row);
    br.fill();
    const int code = read_symbol(T + g.htrees[GREEN], br);
    if (code < kNumLiteralCodes) {
      data[pos++] = uint8_t(code);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kNumLiteralCodes + kNumLengthCodes) {
      const int length = copy_distance(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(T + g.htrees[DIST], br);
      br.fill();
      const int dist_code = copy_distance(dist_symbol, br);
      const int dist = plane_code_to_distance(width, dist_code);
      if (pos >= size_t(dist) && end - pos >= size_t(length)) {
        cov(kCovBackRef);
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      } else {
        ok = false;
        break;
      }
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {
      ok = false;
      break;
    }
    br.eos = br.end_of_stream();
  }
  br.eos = br.end_of_stream();
  return ok && !(br.eos && pos < end);
}

bool decode_image_stream(LDec &d, int xsize, int ysize, bool level0,
                         Meta &hdr, std::vector<uint32_t> *out) {
  LBitReader &br = d.br;
  int txs = xsize, tys = ysize;
  bool ok = true;
  if (level0) {
    while (ok && br.read(1)) ok = read_transform(d, &txs, &tys);
  }
  int cache_bits = 0;
  if (ok && br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) return false;
  }
  if (!ok || !read_huffman_codes(d, hdr, txs, tys, cache_bits, level0))
    return false;
  if (cache_bits > 0) {
    cov(kCovCache);
    hdr.cache_bits = cache_bits;
    hdr.cache.assign(size_t(1) << cache_bits, 0);
  }
  hdr.huffman_xsize = sub_sample(txs, hdr.huffman_bits);
  d.width = txs;
  d.height = tys;
  if (level0) return true;
  out->assign(size_t(txs) * tys, 0);
  ok = decode_image_data(d, hdr, out->data(), txs, tys);
  return ok && !br.eos;
}

// ---------------------------------------------------------------------------
// VP8L: the inverse transforms (lossless.c)
// ---------------------------------------------------------------------------

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb =
      sub3(a >> 24, b >> 24, c >> 24) +
      sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
      sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
      sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t a = clip255((c0 >> 24) + (c1 >> 24) - (c2 >> 24));
  const uint32_t r = clip255(((c0 >> 16) & 0xff) + ((c1 >> 16) & 0xff) - ((c2 >> 16) & 0xff));
  const uint32_t g = clip255(((c0 >> 8) & 0xff) + ((c1 >> 8) & 0xff) - ((c2 >> 8) & 0xff));
  const uint32_t b = clip255((c0 & 0xff) + (c1 & 0xff) - (c2 & 0xff));
  return (a << 24) | (r << 16) | (g << 8) | b;
}

inline int add_subtract_half(int a, int b) {
  return int(clip255(uint32_t(a + (a - b) / 2)));
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_subtract_half(ave >> 24, c2 >> 24);
  const int r = add_subtract_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_subtract_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_subtract_half(ave & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (uint32_t(r) << 16) | (uint32_t(g) << 8) | uint32_t(b);
}

// predictor `mode` for the pixel at out[i] (left out[i-1], top row out[i-w])
inline uint32_t predict(int mode, const uint32_t *out, size_t i, int w) {
  const uint32_t L = out[i - 1];
  const uint32_t *top = out + i - w;
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14, 15 as libwebp pads them
  }
}

void inverse_transform(const Transform &t, const std::vector<uint32_t> &in,
                       std::vector<uint32_t> &out, int height) {
  const int w = t.xsize;
  out.assign(size_t(w) * height, 0);
  if (t.type == PREDICTOR) {
    const int tiles_per_row = sub_sample(w, t.bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t *modes = t.data.data() + size_t(y >> t.bits) * tiles_per_row;
      for (int x = 0; x < w; ++x) {
        const size_t i = size_t(y) * w + x;
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : out[i - 1];
        } else if (x == 0) {
          pred = out[i - w];
        } else {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          if ((x & ((1 << t.bits) - 1)) == 0 || x == 1) cov(kCovPredMode + mode);
          pred = predict(mode, out.data(), i, w);
        }
        out[i] = add_pixels(in[i], pred);
      }
    }
  } else if (t.type == CROSS_COLOR) {
    const int tiles_per_row = sub_sample(w, t.bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t *codes = t.data.data() + size_t(y >> t.bits) * tiles_per_row;
      for (int x = 0; x < w; ++x) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = int8_t(code & 0xff);
        const int8_t g2b = int8_t((code >> 8) & 0xff);
        const int8_t r2b = int8_t((code >> 16) & 0xff);
        const size_t i = size_t(y) * w + x;
        const uint32_t argb = in[i];
        const int8_t green = int8_t(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += (int(g2r) * green) >> 5;
        new_red &= 0xff;
        new_blue += (int(g2b) * green) >> 5;
        new_blue += (int(r2b) * int8_t(new_red)) >> 5;
        new_blue &= 0xff;
        out[i] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
      }
    }
  } else if (t.type == SUBTRACT_GREEN) {
    for (size_t i = 0; i < out.size(); ++i) {
      const uint32_t argb = in[i];
      const uint32_t green = (argb >> 8) & 0xff;
      uint32_t rb = argb & 0x00ff00ffu;
      rb += (green << 16) | green;
      out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
  } else {  // colour indexing, with 8 >> bits bits a pixel when bundled
    const int in_w = sub_sample(w, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    const uint32_t *map = t.data.data();
    for (int y = 0; y < height; ++y) {
      const uint32_t *src = in.data() + size_t(y) * in_w;
      uint32_t *dst = out.data() + size_t(y) * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = map[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
  }
}

void inverse_transforms(const LDec &d, std::vector<uint32_t> &px, int height) {
  std::vector<uint32_t> tmp;
  for (int n = int(d.transforms.size()) - 1; n >= 0; --n) {
    inverse_transform(d.transforms[n], px, tmp, height);
    px.swap(tmp);
  }
}

// ---------------------------------------------------------------------------
// ALPH: the filters' inverses (filters.c)
// ---------------------------------------------------------------------------

void unfilter_row(int filter, const uint8_t *prev, const uint8_t *in,
                  uint8_t *out, int width) {
  if (filter == 0) {
    if (in != out) std::memmove(out, in, width);
    return;
  }
  if (filter == 1 || prev == nullptr) {  // horizontal; every filter's first row
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = uint8_t(pred + in[i]);
      pred = out[i];
    }
    return;
  }
  if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) out[i] = uint8_t(prev[i] + in[i]);
    return;
  }
  uint8_t top = prev[0], top_left = top, left = top;  // gradient
  for (int i = 0; i < width; ++i) {
    top = prev[i];
    const int g = left + top - top_left;
    const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
    left = uint8_t(in[i] + pred);
    top_left = top;
    out[i] = left;
  }
}

}  // namespace

extern "C" {

// A VP8L bitstream (the VP8L chunk's payload, signature byte first) of a
// width x height image -> argb [height * width] (0xAARRGGBB). 0, or -1 for
// a bad header, -2 for another size, -3 for bad prefix codes or
// transforms, -4 for bad pixel data.
int64_t vt_webp_vp8l_decode(const uint8_t *data, int64_t size, int32_t width,
                            int32_t height, uint32_t *argb) {
  LDec d;
  d.br.init(data, size_t(size));
  LBitReader &br = d.br;
  if (br.read(8) != 0x2f) return -1;
  const int w = int(br.read(14)) + 1;
  const int h = int(br.read(14)) + 1;
  br.read(1);
  if (br.read(3) != 0 || br.eos) return -1;
  if (w != width || h != height) return -2;
  Meta hdr;
  if (!decode_image_stream(d, w, h, true, hdr, nullptr)) return -3;
  std::vector<uint32_t> px(size_t(d.width) * h);
  if (!decode_image_data(d, hdr, px.data(), d.width, h)) return -4;
  inverse_transforms(d, px, h);
  std::memcpy(argb, px.data(), px.size() * sizeof(uint32_t));
  return 0;
}

// An ALPH chunk's payload (its header byte first) for a width x height
// frame -> alpha [height * width]. 0, or -1 for a bad header, -2 for raw
// data too short, -3 for bad VP8L-coded data.
int64_t vt_webp_alph_decode(const uint8_t *data, int64_t size, int32_t width,
                            int32_t height, uint8_t *alpha) {
  if (size <= 1) return -1;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return -1;
  const uint8_t *src = data + 1;
  const size_t src_size = size_t(size) - 1;
  const size_t n = size_t(width) * height;
  cov(kCovAlphMethod + method);
  cov(kCovAlphFilter + filter);
  if (method == 0) {
    if (src_size < n) return -2;
    std::memcpy(alpha, src, n);
  } else {
    LDec d;
    d.br.init(src, src_size);
    Meta hdr;
    if (!decode_image_stream(d, width, height, true, hdr, nullptr)) return -3;
    bool use8b = d.transforms.size() == 1 &&
                 d.transforms[0].type == COLOR_INDEXING && hdr.cache.empty();
    for (const auto &g : hdr.groups)
      for (int j : {RED, BLUE, ALPHA})
        if (hdr.tables[g.htrees[j]].bits > 0) use8b = false;
    std::vector<uint32_t> px(size_t(d.width) * height);
    if (use8b) {
      cov(kCovAlph8b);
      std::vector<uint8_t> idx(px.size());
      if (!decode_alpha_8b(d, hdr, idx.data(), d.width, height)) return -3;
      for (size_t i = 0; i < px.size(); ++i) px[i] = uint32_t(idx[i]) << 8;
    } else if (!decode_image_data(d, hdr, px.data(), d.width, height)) {
      return -3;
    }
    inverse_transforms(d, px, height);
    for (size_t i = 0; i < n; ++i) alpha[i] = uint8_t(px[i] >> 8);
  }
  const uint8_t *prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t *row = alpha + size_t(y) * width;
    unfilter_row(filter, prev, row, row, width);
    prev = row;
  }
  return 0;
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// VP8: the boolean decoder (bit_reader_utils.c, bit_reader_inl_utils.h),
// fed a byte at a time; reading past the end feeds one byte of zeros and
// sets eof
// ---------------------------------------------------------------------------

struct BoolReader {
  const uint8_t *buf = nullptr, *end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // the range minus one
  int bits = -8;         // bits in `value` past the current 8-bit window
  int eof = 0;

  void init(const uint8_t *start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = get_value(n);
    return get_value(1) ? -v : v;
  }
  int get_signed(int v) {  // VP8GetSigned: prob 0x80, a shift of one
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
};

// ---------------------------------------------------------------------------
// VP8: headers, modes and tokens (vp8_dec.c, tree_dec.c, quant_dec.c)
// ---------------------------------------------------------------------------

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit, ilevel, inner, hev_thresh;
};

struct VP8Dec {
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void parse_quant(BoolReader &br, VP8Dec &dec) {
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (dec.use_segment) {
      q = dec.quantizer[i];
      if (!dec.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dec.dqm[i] = dec.dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant &m = dec.dqm[i];
    m.y1[0] = kDcTable[clip_q(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip_q(q, 127)];
    m.y2[0] = kDcTable[clip_q(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip_q(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip_q(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip_q(q + dquv_ac, 127)];
  }
}

void precompute_filter_strengths(VP8Dec &dec) {
  if (dec.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (dec.use_segment) {
      base_level = dec.filter_strength[s];
      if (!dec.absolute_delta) base_level += dec.level;
    } else {
      base_level = dec.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo &info = dec.fstrengths[s][i4x4];
      int level = base_level;
      if (dec.use_lf_delta) {
        level += dec.ref_lf_delta[0];
        if (i4x4) level += dec.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (dec.sharpness > 0) {
          ilevel >>= dec.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - dec.sharpness) ilevel = 9 - dec.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
        info.ilevel = 0;
        info.hev_thresh = 0;
      }
      info.inner = i4x4;
    }
  }
}

void parse_intra_mode(BoolReader &br, const VP8Dec &dec, MBData &block,
                      uint8_t *top, uint8_t *left) {
  if (dec.update_map) {
    block.segment = !br.get_bit(dec.segment_proba[0])
                        ? br.get_bit(dec.segment_proba[1])
                        : br.get_bit(dec.segment_proba[2]) + 2;
  } else {
    block.segment = 0;
  }
  if (dec.use_skip_proba) block.skip = br.get_bit(dec.skip_p);
  block.is_i4x4 = !br.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                      : (br.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
    cov(kCovI16 + ymode);
  } else {
    uint8_t *modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t *prob = kBModesProba[top[x]][ymode];
        ymode = !br.get_bit(prob[0]) ? B_DC_PRED
              : !br.get_bit(prob[1]) ? B_TM_PRED
              : !br.get_bit(prob[2]) ? B_VE_PRED
              : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE_PRED
                       : !br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED)
                    : (!br.get_bit(prob[6]) ? B_LD_PRED
                       : !br.get_bit(prob[7]) ? B_VL_PRED
                       : !br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED);
        top[x] = uint8_t(ymode);
        cov(kCovI4 + ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = !br.get_bit(142) ? DC_PRED
               : !br.get_bit(114) ? V_PRED
               : br.get_bit(183) ? TM_PRED : H_PRED;
  cov(kCovUV + block.uvmode);
}

int get_large_value(BoolReader &br, const uint8_t *p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: the tokens of one 4x4 block from coefficient `n`; returns the
// index past the last non-zero coefficient (16 when none ends it early)
int get_coeffs(BoolReader &br, const uint8_t (*bands)[3][11], int ctx,
               const int *dq, int n, int16_t *out) {
  const uint8_t *p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

struct MBCtx {
  uint8_t nz = 0, nz_dc = 0;
};

// ParseResiduals: true when every coefficient is zero
bool parse_residuals(BoolReader &br, const VP8Dec &dec, MBData &block,
                     MBCtx &mb, MBCtx &left_mb) {
  const Quant &q = dec.dqm[block.segment];
  int16_t *dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  int first;
  const uint8_t (*ac_proba)[3][11];
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(br, dec.proba[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = dec.proba[0];
  } else {
    first = 0;
    ac_proba = dec.proba[3];
  }
  uint8_t tnz = mb.nz & 0x0f;
  uint8_t lnz = left_mb.nz & 0x0f;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(mb.nz >> (4 + ch));
    lnz = uint8_t(left_mb.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, dec.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  mb.nz = uint8_t(out_t_nz);
  left_mb.nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ---------------------------------------------------------------------------
// VP8: reconstruction (frame_dec.c ReconstructRow, dsp/dec.c)
// ---------------------------------------------------------------------------

const int BPS = 32;  // the stride of the work buffers

inline uint8_t clip_8b(int v) {
  return uint8_t(!(v & ~0xff) ? v : v < 0 ? 0 : 255);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne; libwebp's DC-only and AC3 shortcuts give the same sums
void transform_add(const int16_t *in, uint8_t *dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip_8b(dst[0] + ((a + d) >> 3));
    dst[1] = clip_8b(dst[1] + ((b + c) >> 3));
    dst[2] = clip_8b(dst[2] + ((b - c) >> 3));
    dst[3] = clip_8b(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip_8b(dst[-1] + top[x] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t *dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void pred4(int mode, uint8_t *dst) {
  const uint8_t *top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)),
                               uint8_t(avg3(B, C, D)), uint8_t(avg3(C, D, E))};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// the 16x16 luma (size 16) and 8x8 chroma (size 8) predictions
void pred_block(int mode, uint8_t *dst, int size) {
  const int sh = size == 16 ? 5 : 4;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> sh);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> (sh - 1));
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> (sh - 1));
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // H_PRED
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

struct Planes {
  int mb_w, mb_h, ys, uvs;
  std::vector<uint8_t> y, u, v;
};

// one macroblock, predicted from the unfiltered pixels around it (127
// above the frame, 129 left of it), into the planes
void reconstruct(Planes &f, const MBData &b, int mb_x, int mb_y) {
  uint8_t yb[BPS * 17], ub[BPS * 9], vb[BPS * 9];
  uint8_t *const y_dst = yb + BPS + 8;
  uint8_t *const u_dst = ub + BPS + 8;
  uint8_t *const v_dst = vb + BPS + 8;
  uint8_t *Y = f.y.data() + size_t(mb_y) * 16 * f.ys + mb_x * 16;
  uint8_t *U = f.u.data() + size_t(mb_y) * 8 * f.uvs + mb_x * 8;
  uint8_t *V = f.v.data() + size_t(mb_y) * 8 * f.uvs + mb_x * 8;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? Y[j * f.ys - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? U[j * f.uvs - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? V[j * f.uvs - 1] : 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = mb_x > 0 ? Y[-f.ys - 1] : 129;
    u_dst[-1 - BPS] = mb_x > 0 ? U[-f.uvs - 1] : 129;
    v_dst[-1 - BPS] = mb_x > 0 ? V[-f.uvs - 1] : 129;
    std::memcpy(y_dst - BPS, Y - f.ys, 16);
    std::memcpy(u_dst - BPS, U - f.uvs, 8);
    std::memcpy(v_dst - BPS, V - f.uvs, 8);
    if (mb_x >= f.mb_w - 1) {
      std::memset(y_dst - BPS + 16, Y[-f.ys + 15], 4);
    } else {
      std::memcpy(y_dst - BPS + 16, Y - f.ys + 16, 4);
    }
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  const int16_t *coeffs = b.coeffs;
  uint32_t bits = b.non_zero_y;
  if (b.is_i4x4) {
    uint8_t *top_right = y_dst - BPS + 16;  // repeated above rows 4, 8, 12
    for (int k = 1; k < 4; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t *dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      pred4(b.imodes[n], dst);
      if (bits >> 30) transform_add(coeffs + n * 16, dst);
    }
  } else {
    pred_block(check_mode(mb_x, mb_y, b.imodes[0]), y_dst, 16);
    for (int n = 0; n < 16; ++n, bits <<= 2)
      if (bits >> 30)
        transform_add(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
  }
  const int uv_mode = check_mode(mb_x, mb_y, b.uvmode);
  pred_block(uv_mode, u_dst, 8);
  pred_block(uv_mode, v_dst, 8);
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t *dst = ch == 0 ? u_dst : v_dst;
    const uint32_t uv_bits = b.non_zero_uv >> (8 * ch);
    if (uv_bits & 0xff)
      for (int n = 0; n < 4; ++n)
        transform_add(coeffs + (16 + 4 * ch + n) * 16,
                      dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
  }
  for (int j = 0; j < 16; ++j) std::memcpy(Y + j * f.ys, y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(U + j * f.uvs, u_dst + j * BPS, 8);
    std::memcpy(V + j * f.uvs, v_dst + j * BPS, 8);
  }
}

// ---------------------------------------------------------------------------
// VP8: the loop filters (dsp/dec.c, frame_dec.c DoFilter)
// ---------------------------------------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline void do_filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = uint8_t(uclip(p0 + a2));
  p[0] = uint8_t(uclip(q0 - a1));
}

inline void do_filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = uint8_t(uclip(p1 + a3));
  p[-step] = uint8_t(uclip(p0 + a2));
  p[0] = uint8_t(uclip(q0 - a1));
  p[step] = uint8_t(uclip(q1 - a3));
}

inline void do_filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uint8_t(uclip(p2 + a3));
  p[-2 * step] = uint8_t(uclip(p1 + a2));
  p[-step] = uint8_t(uclip(p0 + a1));
  p[0] = uint8_t(uclip(q0 - a1));
  p[step] = uint8_t(uclip(q1 - a2));
  p[2 * step] = uint8_t(uclip(q2 - a3));
}

inline bool hev(const uint8_t *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t *p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter along one edge of 16 pixels: hstride across the edge,
// vstride along it
void simple_filter(uint8_t *p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2))
      do_filter2(p + i * vstride, hstride);
}

void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_mb(Planes &f, const FInfo &fi, int filter_type, int mb_x, int mb_y) {
  const int limit = fi.limit;
  if (limit == 0) return;
  const int ys = f.ys, uvs = f.uvs;
  uint8_t *y = f.y.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
  if (filter_type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (fi.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (fi.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t *u = f.u.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t *v = f.v.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  const int il = fi.ilevel, ht = fi.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
    filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
    filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (fi.inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
    filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
    filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
    filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
    filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (fi.inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

// ---------------------------------------------------------------------------
// VP8: output (upsampling.c's "fancy" upsampler, yuv.h)
// ---------------------------------------------------------------------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
  rgb[0] = uint8_t(clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = uint8_t(clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = uint8_t(clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

inline uint32_t load_uv(uint8_t u, uint8_t v) { return u | (uint32_t(v) << 16); }

inline void put(int y, uint32_t uv, uint8_t *dst) {
  yuv_to_rgb(y, uv & 0xff, int(uv >> 16), dst);
}

// UpsampleRgbLinePair: two rows of luma with the chroma rows above (top_*)
// and below (cur_*) them, each output sample (9, 3, 3, 1) / 16 of its four
// nearest chroma samples
void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y,
                   const uint8_t *top_u, const uint8_t *top_v,
                   const uint8_t *cur_u, const uint8_t *cur_v,
                   uint8_t *top_dst, uint8_t *bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  put(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
  if (bottom_y != nullptr)
    put(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    put(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1, top_dst + (2 * x - 1) * 3);
    put(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + (2 * x) * 3);
    if (bottom_y != nullptr) {
      put(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1, bottom_dst + (2 * x - 1) * 3);
      put(bottom_y[2 * x], (diag_12 + uv) >> 1, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    put(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y != nullptr)
      put(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2,
          bottom_dst + (len - 1) * 3);
  }
}

}  // namespace

extern "C" {

// A VP8 key frame (the VP8 chunk's payload, the frame tag first, through
// the end of the data libwebp is given) of width x height -> rgb [height *
// width * 3]. 0, or -1 for a truncated header, -2 for a bad frame tag or
// start code, -3 for a first partition past the data, -4 for a bad
// segment or filter header, -5 for token partitions past the data, -6 for
// a premature end of the first partition, -7 for a premature end of a
// token partition, -9 for another size.
int64_t vt_webp_vp8_decode(const uint8_t *data, int64_t size, int32_t width,
                           int32_t height, uint8_t *rgb) {
  if (size < 4) return -1;
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(tag & 1);
  const int profile = (tag >> 1) & 7;
  const int show = (tag >> 4) & 1;
  const uint32_t partition_length = tag >> 5;
  if (profile > 3 || !show || !key_frame) return -2;
  const uint8_t *buf = data + 3;
  size_t buf_size = size_t(size) - 3;
  if (buf_size < 7) return -1;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return -2;
  const int w = ((buf[4] << 8) | buf[3]) & 0x3fff;
  const int h = ((buf[6] << 8) | buf[5]) & 0x3fff;
  if (w != width || h != height || w == 0 || h == 0) return -9;
  buf += 7;
  buf_size -= 7;
  if (partition_length > buf_size) return -3;
  VP8Dec dec;
  BoolReader br;
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type
  // segment header
  dec.use_segment = br.get_value(1);
  if (dec.use_segment) {
    dec.update_map = br.get_value(1);
    if (br.get_value(1)) {
      dec.absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s)
        dec.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        dec.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (dec.update_map)
      for (int s = 0; s < 3; ++s)
        dec.segment_proba[s] = uint8_t(br.get_value(1) ? br.get_value(8) : 255);
  }
  if (br.eof) return -4;
  // filter header
  dec.simple = br.get_value(1);
  dec.level = br.get_value(6);
  dec.sharpness = br.get_value(3);
  dec.use_lf_delta = br.get_value(1);
  if (dec.use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) dec.ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) dec.mode_lf_delta[i] = br.get_signed_value(6);
  }
  dec.filter_type = dec.level == 0 ? 0 : dec.simple ? 1 : 2;
  if (br.eof) return -4;
  // token partitions
  const int last_part = (1 << br.get_value(2)) - 1;
  if (buf_size < size_t(3 * last_part)) return -5;
  std::vector<BoolReader> parts(last_part + 1);
  {
    const uint8_t *sz = buf;
    const uint8_t *part_start = buf + last_part * 3;
    const uint8_t *buf_end = buf + buf_size;
    size_t size_left = buf_size - last_part * 3;
    for (int p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) return -5;
  }
  parse_quant(br, dec);
  br.get_value(1);  // update_proba, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          dec.proba[t][b][c][p] = uint8_t(
              br.get_bit(kCoeffsUpdateProba[t][b][c][p]) ? br.get_value(8)
                                                         : kCoeffsProba0[t][b][c][p]);
  dec.use_skip_proba = br.get_value(1);
  if (dec.use_skip_proba) dec.skip_p = br.get_value(8);

  cov(kCovFilter + dec.filter_type);
  if (dec.sharpness > 0) cov(kCovSharp);
  cov(kCovParts + (last_part == 0 ? 0 : last_part == 1 ? 1 : last_part == 3 ? 2 : 3));
  if (dec.use_segment) cov(kCovSegments);
  if (dec.use_lf_delta) cov(kCovLfDelta);
  if (dec.use_skip_proba) cov(kCovSkip);
  precompute_filter_strengths(dec);

  const int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  Planes f;
  f.mb_w = mb_w;
  f.mb_h = mb_h;
  f.ys = mb_w * 16;
  f.uvs = mb_w * 8;
  f.y.assign(size_t(f.ys) * mb_h * 16, 0);
  f.u.assign(size_t(f.uvs) * mb_h * 8, 0);
  f.v.assign(size_t(f.uvs) * mb_h * 8, 0);
  std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
  std::vector<MBData> row(mb_w);
  std::vector<MBCtx> mb_info(mb_w);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader &token_br = parts[mb_y & last_part];
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    MBCtx left;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      parse_intra_mode(br, dec, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (br.eof) return -6;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData &block = row[mb_x];
      MBCtx &mb = mb_info[mb_x];
      int skip = dec.use_skip_proba ? block.skip : 0;
      if (!skip) {
        skip = parse_residuals(token_br, dec, block, mb, left);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo &fi = finfo[size_t(mb_y) * mb_w + mb_x];
        fi = dec.fstrengths[block.segment][block.is_i4x4];
        fi.inner |= !skip;
      }
      if (token_br.eof) return -7;
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) reconstruct(f, row[mb_x], mb_x, mb_y);
  }
  if (dec.filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(f, finfo[size_t(mb_y) * mb_w + mb_x], dec.filter_type, mb_x, mb_y);
  // output: row 0 alone, then pairs of rows between chroma rows, then the
  // last row of an even height alone
  const uint8_t *Y = f.y.data(), *U = f.u.data(), *V = f.v.data();
  const size_t stride = size_t(w) * 3;
  upsample_pair(Y, nullptr, U, V, U, V, rgb, nullptr, w);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const size_t t = size_t((y - 1) >> 1) * f.uvs, c = size_t((y + 1) >> 1) * f.uvs;
    upsample_pair(Y + size_t(y) * f.ys, Y + size_t(y + 1) * f.ys, U + t, V + t,
                  U + c, V + c, rgb + y * stride, rgb + (y + 1) * stride, w);
  }
  if (h > 1 && !(h & 1)) {
    const size_t c = size_t((h - 1) >> 1) * f.uvs;
    upsample_pair(Y + size_t(h - 1) * f.ys, nullptr, U + c, V + c, U + c, V + c,
                  rgb + (h - 1) * stride, nullptr, w);
  }
  return 0;
}

// The path counters: out [kCovCount]; reset != 0 clears them after.
int64_t vt_webp_coverage(int64_t *out, int32_t reset) {
  std::memcpy(out, g_cov, sizeof(g_cov));
  if (reset) std::memset(g_cov, 0, sizeof(g_cov));
  return kCovCount;
}

}  // extern "C"

// Serial per-tile work of an AV1 decoder for the lossless intra frames of
// AVIF files, decoded as dav1d 1.5.1 (the decoder libavif 1.3.0 hands them
// to under PIL 12.1.0) decodes them: the symbol decoder and its CDF
// adaptation, the partition tree, intra frame mode info (segment ids,
// skip, Y / UV modes with angle deltas, CFL alphas, palettes with their
// colour cache and colour-index maps, filter intra), the 4x4 coefficients
// of a lossless frame with their contexts, the inverse Walsh-Hadamard
// transform and every intra predictor (DC, directional with the intra edge
// filter and edge upsampling, smooth, smooth-V, smooth-H, Paeth, CFL,
// filter intra, palette). The container, the OBUs and the headers are read
// in `scene/avif.py`, which calls `vt_av1_decode_frame` once per frame.
//
// The default CDF tables below are the rows of the AV1 specification that a
// lossless key frame reads (the coefficient CDFs of quantiser context 0 at
// TX_4X4); `tools/gen_torch_avif.py` finds each row, in libaom's inverted
// layout, in the libavif shared library that PIL ships.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Default CDFs (specification values, without the final 32768).

static const uint16_t KF_Y_MODE[25][12] = {
    {15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466},
    {12016, 18066, 19516, 20303, 20719, 21444, 21888, 23032, 24434, 28658, 30172, 31409},
    {10052, 10771, 22296, 22788, 23055, 23239, 24133, 25620, 26160, 29336, 29929, 31567},
    {14091, 15406, 16442, 18808, 19136, 19546, 19998, 22096, 24746, 29585, 30958, 32462},
    {12122, 13265, 15603, 16501, 18609, 20033, 22391, 25583, 26437, 30261, 31073, 32475},
    {10023, 19585, 20848, 21440, 21832, 22760, 23089, 24023, 25381, 29014, 30482, 31436},
    {5983, 24099, 24560, 24886, 25066, 25795, 25913, 26423, 27610, 29905, 31276, 31794},
    {7444, 12781, 20177, 20728, 21077, 21607, 22170, 23405, 24469, 27915, 29090, 30492},
    {8537, 14689, 15432, 17087, 17408, 18172, 18408, 19825, 24649, 29153, 31096, 32210},
    {7543, 14231, 15496, 16195, 17905, 20717, 21984, 24516, 26001, 29675, 30981, 31994},
    {12613, 13591, 21383, 22004, 22312, 22577, 23401, 25055, 25729, 29538, 30305, 32077},
    {9687, 13470, 18506, 19230, 19604, 20147, 20695, 22062, 23219, 27743, 29211, 30907},
    {6183, 6505, 26024, 26252, 26366, 26434, 27082, 28354, 28555, 30467, 30794, 32086},
    {10718, 11734, 14954, 17224, 17565, 17924, 18561, 21523, 23878, 28975, 30287, 32252},
    {9194, 9858, 16501, 17263, 18424, 19171, 21563, 25961, 26561, 30072, 30737, 32463},
    {12602, 14399, 15488, 18381, 18778, 19315, 19724, 21419, 25060, 29696, 30917, 32409},
    {8203, 13821, 14524, 17105, 17439, 18131, 18404, 19468, 25225, 29485, 31158, 32342},
    {8451, 9731, 15004, 17643, 18012, 18425, 19070, 21538, 24605, 29118, 30078, 32018},
    {7714, 9048, 9516, 16667, 16817, 16994, 17153, 18767, 26743, 30389, 31536, 32528},
    {8843, 10280, 11496, 15317, 16652, 17943, 19108, 22718, 25769, 29953, 30983, 32485},
    {12578, 13671, 15979, 16834, 19075, 20913, 22989, 25449, 26219, 30214, 31150, 32477},
    {9563, 13626, 15080, 15892, 17756, 20863, 22207, 24236, 25380, 29653, 31143, 32277},
    {8356, 8901, 17616, 18256, 19350, 20106, 22598, 25947, 26466, 29900, 30523, 32261},
    {10835, 11815, 13124, 16042, 17018, 18039, 18947, 22753, 24615, 29489, 30883, 32482},
    {7618, 8288, 9859, 10509, 15386, 18657, 22903, 28776, 29180, 31355, 31802, 32593},
};

static const uint16_t UV_MODE_NOCFL[13][12] = {
    {22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059, 30941, 31961},
    {9513, 26881, 26973, 27046, 27118, 27664, 27739, 27824, 28359, 29505, 29800, 31796},
    {9845, 9915, 28663, 28704, 28757, 28780, 29198, 29822, 29854, 30764, 31777, 32029},
    {13639, 13897, 14171, 25331, 25606, 25727, 25953, 27148, 28577, 30612, 31355, 32493},
    {9764, 9835, 9930, 9954, 25386, 27053, 27958, 28148, 28243, 31101, 31744, 32363},
    {11825, 13589, 13677, 13720, 15048, 29213, 29301, 29458, 29711, 31161, 31441, 32550},
    {14175, 14399, 16608, 16821, 17718, 17775, 28551, 30200, 30245, 31837, 32342, 32667},
    {12885, 13038, 14978, 15590, 15673, 15748, 16176, 29128, 29267, 30643, 31961, 32461},
    {12026, 13661, 13874, 15305, 15490, 15726, 15995, 16273, 28443, 30388, 30767, 32416},
    {19052, 19840, 20579, 20916, 21150, 21467, 21885, 22719, 23174, 28861, 30379, 32175},
    {18627, 19649, 20974, 21219, 21492, 21816, 22199, 23119, 23527, 27053, 31397, 32148},
    {17026, 19004, 19997, 20339, 20586, 21103, 21349, 21907, 22482, 25896, 26541, 31819},
    {12124, 13759, 14959, 14992, 15007, 15051, 15078, 15166, 15255, 15753, 16039, 16606},
};

static const uint16_t UV_MODE_CFL[13][13] = {
    {10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086, 20995, 22455, 24212},
    {4532, 19780, 20057, 20215, 20428, 21071, 21199, 21451, 22099, 24228, 24693, 27032, 29472},
    {5273, 5379, 20177, 20270, 20385, 20439, 20949, 21695, 21774, 23138, 24256, 24703, 26679},
    {6740, 7167, 7662, 14152, 14536, 14785, 15034, 16741, 18371, 21520, 22206, 23389, 24182},
    {4987, 5368, 5928, 6068, 19114, 20315, 21857, 22253, 22411, 24911, 25380, 26027, 26376},
    {5370, 6889, 7247, 7393, 9498, 21114, 21402, 21753, 21981, 24780, 25386, 26517, 27176},
    {4816, 4961, 7204, 7326, 8765, 8930, 20169, 20682, 20803, 23188, 23763, 24455, 24940},
    {6608, 6740, 8529, 9049, 9257, 9356, 9735, 18827, 19059, 22336, 23204, 23964, 24793},
    {5998, 7419, 7781, 8933, 9255, 9549, 9753, 10417, 18898, 22494, 23139, 24764, 25989},
    {10660, 11298, 12550, 12957, 13322, 13624, 14040, 15004, 15534, 20714, 21789, 23443, 24861},
    {10522, 11530, 12552, 12963, 13378, 13779, 14245, 15235, 15902, 20102, 22696, 23774, 25838},
    {10099, 10691, 12639, 13049, 13386, 13665, 14125, 15163, 15636, 19676, 20474, 23519, 25208},
    {3144, 5087, 7382, 7504, 7593, 7690, 7801, 8064, 8232, 9248, 9875, 10521, 29048},
};

static const uint16_t ANGLE_DELTA[8][6] = {
    {2180, 5032, 7567, 22776, 26989, 30217},
    {2301, 5608, 8801, 23487, 26974, 30330},
    {3780, 11018, 13699, 19354, 23083, 31286},
    {4581, 11226, 15147, 17138, 21834, 28397},
    {1737, 10927, 14509, 19588, 22745, 28823},
    {2664, 10176, 12485, 17650, 21600, 30495},
    {2240, 11096, 15453, 20341, 22561, 28917},
    {3605, 10428, 12459, 17676, 21244, 30655},
};

static const uint16_t PARTITION_W8[4][3] = {
    {19132, 25510, 30392},
    {13928, 19855, 28540},
    {12522, 23679, 28629},
    {9896, 18783, 25853},
};

static const uint16_t PARTITION_W16_64[12][9] = {
    {15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902},
    {7925, 11043, 16785, 22470, 23971, 25043, 26651, 28701, 29834},
    {5414, 13269, 15111, 20488, 22360, 24500, 25537, 26336, 32117},
    {2662, 6362, 8614, 20860, 23053, 24778, 26436, 27829, 31171},
    {18462, 20920, 23124, 27647, 28227, 29049, 29519, 30178, 31544},
    {7689, 9060, 12056, 24992, 25660, 26182, 26951, 28041, 29052},
    {6015, 9009, 10062, 24544, 25409, 26545, 27071, 27526, 32047},
    {1394, 2208, 2796, 28614, 29061, 29466, 29840, 30185, 31899},
    {20137, 21547, 23078, 29566, 29837, 30261, 30524, 30892, 31724},
    {6732, 7490, 9497, 27944, 28250, 28515, 28969, 29630, 30104},
    {5945, 7663, 8348, 28683, 29117, 29749, 30064, 30298, 32238},
    {870, 1212, 1487, 31198, 31394, 31574, 31743, 31881, 32332},
};

static const uint16_t PARTITION_W128[4][7] = {
    {27899, 28219, 28529, 32484, 32539, 32619, 32639},
    {6607, 6990, 8268, 32060, 32219, 32338, 32371},
    {5429, 6676, 7122, 32027, 32227, 32531, 32582},
    {711, 966, 1172, 32448, 32538, 32617, 32664},
};

static const uint16_t SKIP[3][1] = {
    {31671},
    {16515},
    {4576},
};

static const uint16_t SEGMENT_ID[3][7] = {
    {5622, 7893, 16093, 18233, 27809, 28373, 32533},
    {14274, 18230, 22557, 24935, 29980, 30851, 32344},
    {27527, 28487, 28723, 28890, 32397, 32647, 32679},
};

static const uint16_t CFL_SIGN[1][7] = {
    {1418, 2123, 13340, 18405, 26972, 28343, 32294},
};

static const uint16_t CFL_ALPHA[6][15] = {
    {7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708, 32712, 32716, 32720, 32724},
    {14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620, 32647, 32668, 32672, 32676, 32680, 32684},
    {11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673, 32677, 32681, 32685, 32689, 32693, 32697},
    {26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708, 32712, 32716, 32720, 32724, 32728, 32732},
    {17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394, 32464, 32516, 32560, 32576, 32593, 32622},
    {14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144, 32413, 32520, 32594, 32622, 32656, 32660},
};

static const uint16_t FILTER_INTRA[22][1] = {
    {4621},
    {6743},
    {5893},
    {7866},
    {12551},
    {9394},
    {12408},
    {14301},
    {12756},
    {22343},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
    {12770},
    {10368},
    {20229},
    {18101},
    {16384},
    {16384},
};

static const uint16_t FILTER_INTRA_MODE[1][4] = {
    {8949, 12776, 17211, 29558},
};

static const uint16_t PALETTE_Y_MODE[21][1] = {
    {31676},
    {3419},
    {1261},
    {31912},
    {2859},
    {980},
    {31823},
    {3400},
    {781},
    {32030},
    {3561},
    {904},
    {32309},
    {7337},
    {1462},
    {32265},
    {4015},
    {1521},
    {32450},
    {7946},
    {129},
};

static const uint16_t PALETTE_UV_MODE[2][1] = {
    {32461},
    {21488},
};

static const uint16_t PALETTE_Y_SIZE[7][6] = {
    {7952, 13000, 18149, 21478, 25527, 29241},
    {7139, 11421, 16195, 19544, 23666, 28073},
    {7788, 12741, 17325, 20500, 24315, 28530},
    {8271, 14064, 18246, 21564, 25071, 28533},
    {12725, 19180, 21863, 24839, 27535, 30120},
    {9711, 14888, 16923, 21052, 25661, 27875},
    {14940, 20797, 21678, 24186, 27033, 28999},
};

static const uint16_t PALETTE_UV_SIZE[7][6] = {
    {8713, 19979, 27128, 29609, 31331, 32272},
    {5839, 15573, 23581, 26947, 29848, 31700},
    {4426, 11260, 17999, 21483, 25863, 29430},
    {3228, 9464, 14993, 18089, 22523, 27420},
    {3768, 8886, 13091, 17852, 22495, 27207},
    {2464, 8451, 12861, 21632, 25525, 28555},
    {1269, 5435, 10433, 18963, 21700, 25865},
};

static const uint16_t PALETTE_Y_COLOR[35][7] = {
    {28710, 0, 0, 0, 0, 0, 0},
    {16384, 0, 0, 0, 0, 0, 0},
    {10553, 0, 0, 0, 0, 0, 0},
    {27036, 0, 0, 0, 0, 0, 0},
    {31603, 0, 0, 0, 0, 0, 0},
    {27877, 30490, 0, 0, 0, 0, 0},
    {11532, 25697, 0, 0, 0, 0, 0},
    {6544, 30234, 0, 0, 0, 0, 0},
    {23018, 28072, 0, 0, 0, 0, 0},
    {31915, 32385, 0, 0, 0, 0, 0},
    {25572, 28046, 30045, 0, 0, 0, 0},
    {9478, 21590, 27256, 0, 0, 0, 0},
    {7248, 26837, 29824, 0, 0, 0, 0},
    {19167, 24486, 28349, 0, 0, 0, 0},
    {31400, 31825, 32250, 0, 0, 0, 0},
    {24779, 26955, 28576, 30282, 0, 0, 0},
    {8669, 20364, 24073, 28093, 0, 0, 0},
    {4255, 27565, 29377, 31067, 0, 0, 0},
    {19864, 23674, 26716, 29530, 0, 0, 0},
    {31646, 31893, 32147, 32426, 0, 0, 0},
    {23132, 25407, 26970, 28435, 30073, 0, 0},
    {7443, 17242, 20717, 24762, 27982, 0, 0},
    {6300, 24862, 26944, 28784, 30671, 0, 0},
    {18916, 22895, 25267, 27435, 29652, 0, 0},
    {31270, 31550, 31808, 32059, 32353, 0, 0},
    {23105, 25199, 26464, 27684, 28931, 30318, 0},
    {6950, 15447, 18952, 22681, 25567, 28563, 0},
    {7560, 23474, 25490, 27203, 28921, 30708, 0},
    {18544, 22373, 24457, 26195, 28119, 30045, 0},
    {31198, 31451, 31670, 31882, 32123, 32391, 0},
    {21689, 23883, 25163, 26352, 27506, 28827, 30195},
    {6892, 15385, 17840, 21606, 24287, 26753, 29204},
    {5651, 23182, 25042, 26518, 27982, 29392, 30900},
    {19349, 22578, 24418, 25994, 27524, 29031, 30448},
    {31028, 31270, 31504, 31705, 31927, 32153, 32392},
};

static const uint16_t PALETTE_UV_COLOR[35][7] = {
    {29089, 0, 0, 0, 0, 0, 0},
    {16384, 0, 0, 0, 0, 0, 0},
    {8713, 0, 0, 0, 0, 0, 0},
    {29257, 0, 0, 0, 0, 0, 0},
    {31610, 0, 0, 0, 0, 0, 0},
    {25257, 29145, 0, 0, 0, 0, 0},
    {12287, 27293, 0, 0, 0, 0, 0},
    {7033, 27960, 0, 0, 0, 0, 0},
    {20145, 25405, 0, 0, 0, 0, 0},
    {30608, 31639, 0, 0, 0, 0, 0},
    {24210, 27175, 29903, 0, 0, 0, 0},
    {9888, 22386, 27214, 0, 0, 0, 0},
    {5901, 26053, 29293, 0, 0, 0, 0},
    {18318, 22152, 28333, 0, 0, 0, 0},
    {30459, 31136, 31926, 0, 0, 0, 0},
    {22980, 25479, 27781, 29986, 0, 0, 0},
    {8413, 21408, 24859, 28874, 0, 0, 0},
    {2257, 29449, 30594, 31598, 0, 0, 0},
    {19189, 21202, 25915, 28620, 0, 0, 0},
    {31844, 32044, 32281, 32518, 0, 0, 0},
    {22217, 24567, 26637, 28683, 30548, 0, 0},
    {7307, 16406, 19636, 24632, 28424, 0, 0},
    {4441, 25064, 26879, 28942, 30919, 0, 0},
    {17210, 20528, 23319, 26750, 29582, 0, 0},
    {30674, 30953, 31396, 31735, 32207, 0, 0},
    {21239, 23168, 25044, 26962, 28705, 30506, 0},
    {6545, 15012, 18004, 21817, 25503, 28701, 0},
    {3448, 26295, 27437, 28704, 30126, 31442, 0},
    {15889, 18323, 21704, 24698, 26976, 29690, 0},
    {30988, 31204, 31479, 31734, 31983, 32325, 0},
    {21442, 23288, 24758, 26246, 27649, 28980, 30563},
    {5863, 14933, 17552, 20668, 23683, 26411, 29273},
    {3415, 25810, 26877, 27990, 29223, 30394, 31618},
    {17965, 20084, 22232, 23974, 26274, 28402, 30390},
    {31190, 31329, 31516, 31679, 31825, 32026, 32322},
};

static const uint16_t TXB_SKIP[13][1] = {
    {31849},
    {5892},
    {12112},
    {21935},
    {20289},
    {27473},
    {32487},
    {7654},
    {19473},
    {29984},
    {9961},
    {30242},
    {32117},
};

static const uint16_t EOB_PT_16[4][4] = {
    {840, 1039, 1980, 4895},
    {370, 671, 1883, 4471},
    {3247, 4950, 9688, 14563},
    {1904, 3354, 7763, 14647},
};

static const uint16_t EOB_EXTRA[18][1] = {
    {16961},
    {17223},
    {7621},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
    {19069},
    {22525},
    {13377},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
    {16384},
};

static const uint16_t DC_SIGN[6][1] = {
    {16000},
    {13056},
    {18816},
    {15232},
    {12928},
    {17280},
};

static const uint16_t COEFF_BASE_EOB[8][2] = {
    {17837, 29055},
    {29600, 31446},
    {30844, 31878},
    {24926, 28948},
    {21365, 30026},
    {30512, 32423},
    {31658, 32621},
    {29630, 31881},
};

static const uint16_t COEFF_BASE[84][3] = {
    {4034, 8930, 12727},
    {18082, 29741, 31877},
    {12596, 26124, 30493},
    {9446, 21118, 27005},
    {6308, 15141, 21279},
    {2463, 6357, 9783},
    {20667, 30546, 31929},
    {13043, 26123, 30134},
    {8151, 18757, 24778},
    {5255, 12839, 18632},
    {2820, 7206, 11161},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {15736, 27553, 30604},
    {11210, 23794, 28787},
    {5947, 13874, 19701},
    {4215, 9323, 13891},
    {2833, 6462, 10059},
    {19605, 30393, 31582},
    {13523, 26252, 30248},
    {8446, 18622, 24512},
    {3818, 10343, 15974},
    {1481, 4117, 6796},
    {22649, 31302, 32190},
    {14829, 27127, 30449},
    {8313, 17702, 23304},
    {3022, 8301, 12786},
    {1536, 4412, 7184},
    {22354, 29774, 31372},
    {14723, 25472, 29214},
    {6673, 13745, 18662},
    {2068, 5766, 9322},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {6302, 16444, 21761},
    {23040, 31538, 32475},
    {15196, 28452, 31496},
    {10020, 22946, 28514},
    {6533, 16862, 23501},
    {3538, 9816, 15076},
    {24444, 31875, 32525},
    {15881, 28924, 31635},
    {9922, 22873, 28466},
    {6527, 16966, 23691},
    {4114, 11303, 17220},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
    {20201, 30770, 32209},
    {14754, 28071, 31258},
    {8378, 20186, 26517},
    {5916, 15299, 21978},
    {4268, 11583, 17901},
    {24361, 32025, 32581},
    {18673, 30105, 31943},
    {10196, 22244, 27576},
    {5495, 14349, 20417},
    {2676, 7415, 11498},
    {24678, 31958, 32585},
    {18629, 29906, 31831},
    {9364, 20724, 26315},
    {4641, 12318, 18094},
    {2758, 7387, 11579},
    {25433, 31842, 32469},
    {18795, 29289, 31411},
    {7644, 17584, 23592},
    {3408, 9014, 15047},
    {8192, 16384, 24576},
    {8192, 16384, 24576},
};

static const uint16_t COEFF_BR[42][3] = {
    {14298, 20718, 24174},
    {12536, 19601, 23789},
    {8712, 15051, 19503},
    {6170, 11327, 15434},
    {4742, 8926, 12538},
    {3803, 7317, 10546},
    {1696, 3317, 4871},
    {14392, 19951, 22756},
    {15978, 23218, 26818},
    {12187, 19474, 23889},
    {9176, 15640, 20259},
    {7068, 12655, 17028},
    {5656, 10442, 14472},
    {2580, 4992, 7244},
    {12136, 18049, 21426},
    {13784, 20721, 24481},
    {10836, 17621, 21900},
    {8372, 14444, 18847},
    {6523, 11779, 16000},
    {5337, 9898, 13760},
    {3034, 5860, 8462},
    {15967, 22905, 26286},
    {13534, 20654, 24579},
    {9504, 16092, 20535},
    {6975, 12568, 16903},
    {5364, 10091, 14020},
    {4357, 8370, 11857},
    {2506, 4934, 7218},
    {23032, 28815, 30936},
    {19540, 26704, 29719},
    {15158, 22969, 27097},
    {11408, 18865, 23650},
    {8885, 15448, 20250},
    {7108, 12853, 17416},
    {4231, 8041, 11480},
    {19823, 26490, 29156},
    {18890, 25929, 28932},
    {15660, 23491, 27433},
    {12147, 19776, 24488},
    {9728, 16774, 21649},
    {7919, 14277, 19066},
    {5440, 10170, 14185},
};

// ---------------------------------------------------------------------------
// The small tables of the AV1 specification (block geometry, prediction
// weights and taps) that a lossless intra frame reaches.

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
       PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID };

static const uint8_t NUM_4X4_W[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16,
                                      16, 32, 32, 1, 4, 2, 8, 4, 16};
static const uint8_t NUM_4X4_H[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16,
                                      32, 16, 32, 4, 1, 8, 2, 16, 4};
static const uint8_t MI_W_LOG2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4,
                                      4, 5, 5, 0, 2, 1, 3, 2, 4};
static const uint8_t MI_H_LOG2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4,
                                      5, 4, 5, 2, 0, 3, 1, 4, 2};
// Subsampled_Size[bsize][subsampling_x][subsampling_y]
static const uint8_t SS_SIZE[22][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};
static const uint8_t INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0,
                                               1, 2, 0};
static const uint8_t MODE_TO_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203,
                                          67, 0, 0, 0, 0};
// Dr_Intra_Derivative, indexed by angle (3 .. 87)
static const uint16_t DR_INTRA_DERIVATIVE[90] = {
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215, 0, 0,
    178, 0, 0, 151, 0, 0, 132, 0, 0, 116, 0, 0, 102, 0, 0, 0, 90, 0, 0, 80,
    0, 0, 71, 0, 0, 64, 0, 0, 57, 0, 0, 51, 0, 0, 45, 0, 0, 0, 40, 0, 0, 35,
    0, 0, 31, 0, 0, 27, 0, 0, 23, 0, 0, 19, 0, 0, 15, 0, 0, 0, 0, 11, 0, 0,
    7, 0, 0, 3, 0, 0};
static const int8_t INTRA_FILTER_TAPS[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0},
     {-3, 1, 1, 10, 0, 7, 0}, {-3, 1, 1, 2, 10, 5, 0},
     {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9},
     {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0},
     {-4, 0, 0, 16, 0, 4, 0}, {-2, 0, 0, 0, 16, 2, 0},
     {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6},
     {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0},
     {-8, 0, 0, 8, 0, 16, 0}, {-8, 0, 0, 0, 8, 16, 0},
     {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16},
     {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0},
     {-1, 2, 3, 8, 0, 4, 0}, {0, 1, 2, 3, 8, 2, 0},
     {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6},
     {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0},
     {-9, 0, 0, 14, 0, 11, 0}, {-8, 0, 0, 0, 14, 10, 0},
     {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12},
     {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};
static const uint8_t SM_WEIGHTS_4[4] = {255, 149, 85, 64};
static const uint8_t INTRA_EDGE_KERNEL[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
static const uint8_t DEFAULT_SCAN_4X4[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                             9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t COEFF_BASE_CTX_OFFSET_4X4[5][5] = {
    {0, 1, 6, 6, 0}, {1, 6, 6, 21, 0}, {6, 6, 21, 21, 0},
    {6, 21, 21, 21, 0}, {0, 0, 0, 0, 0}};
static const int8_t PALETTE_COLOR_CONTEXT[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};

// ---------------------------------------------------------------------------
// The symbol decoder, as dav1d's msac decodes: a 64-bit window holding the
// inverted bits, refilled a byte at a time; past the end of the tile's data
// the refill sets the rest of the window to ones (inverted zeros) and, once
// the count has gone negative, no longer refills.

struct Msac {
  const uint8_t *pos, *end;
  uint64_t dif;
  unsigned rng;
  int cnt;
  bool update;

  void refill() {
    int c = 64 - cnt - 24;
    uint64_t d = dif;
    do {
      if (pos >= end) {
        d |= ~(~(uint64_t)0xff << c);
        break;
      }
      d |= (uint64_t)(*pos++ ^ 0xff) << c;
      c -= 8;
    } while (c >= 0);
    dif = d;
    cnt = 64 - c - 24;
  }
  void init(const uint8_t* data, size_t sz, bool disable_update) {
    pos = data;
    end = data + sz;
    dif = 0;
    rng = 0x8000;
    cnt = -15;
    update = !disable_update;
    refill();
  }
  void norm(uint64_t d, unsigned r) {
    const int sh = 15 ^ (31 ^ __builtin_clz(r));
    const int c = cnt;
    dif = d << sh;
    rng = r << sh;
    cnt = c - sh;
    if ((unsigned)c < (unsigned)sh) refill();
  }
  int boolf(unsigned f) {
    const unsigned r = rng;
    uint64_t d = dif;
    unsigned v = ((r >> 8) * (f >> 6) >> 1) + 4;
    const uint64_t vw = (uint64_t)v << 48;
    const unsigned ret = d >= vw;
    d -= ret * vw;
    v += ret * (r - 2 * v);
    norm(d, v);
    return !ret;
  }
  int equi() {
    const unsigned r = rng;
    uint64_t d = dif;
    unsigned v = ((r >> 8) << 7) + 4;
    const uint64_t vw = (uint64_t)v << 48;
    const unsigned ret = d >= vw;
    d -= ret * vw;
    v += ret * (r - 2 * v);
    norm(d, v);
    return !ret;
  }
  unsigned lit(int bits) {
    unsigned v = 0;
    for (int i = 0; i < bits; i++) v = (v << 1) | equi();
    return v;
  }
  // cdf: n - 1 inverted probabilities, a terminating 0, then the count
  int sym(uint16_t* cdf, int n) {
    const unsigned c = (unsigned)(dif >> 48), r = rng >> 8;
    unsigned u, v = rng;
    int val = -1;
    do {
      val++;
      u = v;
      v = r * (cdf[val] >> 6) >> 1;
      v += 4 * (unsigned)(n - 1 - val);
    } while (c < v);
    norm(dif - ((uint64_t)v << 48), u - v);
    if (update) {
      const unsigned count = cdf[n];
      const int rate = 4 + (count >> 4) + (n > 3);
      int i;
      for (i = 0; i < val; i++) cdf[i] += (32768 - cdf[i]) >> rate;
      for (; i < n - 1; i++) cdf[i] -= cdf[i] >> rate;
      cdf[n] = count + (count < 32);
    }
    return val;
  }
  int bool_adapt(uint16_t* cdf) { return sym(cdf, 2); }
  unsigned golomb() {
    int len = 0;
    unsigned val = 1;
    while (!equi() && len < 32) len++;
    while (len--) val = (val << 1) + equi();
    return val - 1;
  }
};

// ---------------------------------------------------------------------------
// The CDFs a tile adapts, loaded from the default tables at its start.

struct Cdfs {
  uint16_t kf_y[25][14];
  uint16_t uv_nocfl[13][14];
  uint16_t uv_cfl[13][15];
  uint16_t angle[8][8];
  uint16_t part[5][4][11];
  uint16_t skip[3][3];
  uint16_t seg[3][9];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t fi[22][3];
  uint16_t fi_mode[6];
  uint16_t pal_y[21][3];
  uint16_t pal_uv[2][3];
  uint16_t pal_y_size[7][8];
  uint16_t pal_uv_size[7][8];
  uint16_t pal_y_color[35][9];
  uint16_t pal_uv_color[35][9];
  uint16_t txb_skip[13][3];
  uint16_t eob16[4][6];
  uint16_t eob_extra[18][3];
  uint16_t dc_sign[6][3];
  uint16_t base_eob[8][4];
  uint16_t base[84][5];
  uint16_t br[42][5];
};

// one CDF of n symbols from its n - 1 specification values
static void load(uint16_t* dst, const uint16_t* src, int n) {
  for (int i = 0; i < n - 1; i++) dst[i] = 32768 - src[i];
  dst[n - 1] = 0;
  dst[n] = 0;
}
template <int R, int C, int S>
static void load_rows(uint16_t (&dst)[R][S], const uint16_t (&src)[R][C],
                      int n) {
  for (int r = 0; r < R; r++) load(dst[r], src[r], n);
}

static void init_cdfs(Cdfs& c) {
  memset(&c, 0, sizeof c);
  load_rows(c.kf_y, KF_Y_MODE, 13);
  load_rows(c.uv_nocfl, UV_MODE_NOCFL, 13);
  load_rows(c.uv_cfl, UV_MODE_CFL, 14);
  load_rows(c.angle, ANGLE_DELTA, 7);
  for (int i = 0; i < 4; i++) {
    load(c.part[0][i], PARTITION_W8[i], 4);
    for (int l = 0; l < 3; l++)
      load(c.part[1 + l][i], PARTITION_W16_64[4 * l + i], 10);
    load(c.part[4][i], PARTITION_W128[i], 8);
  }
  load_rows(c.skip, SKIP, 2);
  load_rows(c.seg, SEGMENT_ID, 8);
  load(c.cfl_sign, CFL_SIGN[0], 8);
  load_rows(c.cfl_alpha, CFL_ALPHA, 16);
  load_rows(c.fi, FILTER_INTRA, 2);
  load(c.fi_mode, FILTER_INTRA_MODE[0], 5);
  load_rows(c.pal_y, PALETTE_Y_MODE, 2);
  load_rows(c.pal_uv, PALETTE_UV_MODE, 2);
  load_rows(c.pal_y_size, PALETTE_Y_SIZE, 7);
  load_rows(c.pal_uv_size, PALETTE_UV_SIZE, 7);
  for (int s = 0; s < 7; s++)
    for (int k = 0; k < 5; k++) {
      load(c.pal_y_color[s * 5 + k], PALETTE_Y_COLOR[s * 5 + k], s + 2);
      load(c.pal_uv_color[s * 5 + k], PALETTE_UV_COLOR[s * 5 + k], s + 2);
    }
  load_rows(c.txb_skip, TXB_SKIP, 2);
  load_rows(c.eob16, EOB_PT_16, 5);
  load_rows(c.eob_extra, EOB_EXTRA, 2);
  load_rows(c.dc_sign, DC_SIGN, 2);
  load_rows(c.base_eob, COEFF_BASE_EOB, 3);
  load_rows(c.base, COEFF_BASE, 4);
  load_rows(c.br, COEFF_BR, 4);
}

// ---------------------------------------------------------------------------
// The frame: its planes, the per-4x4 mode info and the coefficient contexts.

// counters of the coding tools met (tests check that the committed files
// reach each of them)
enum {
  COV_YMODE = 0,          // 13
  COV_UVMODE = 13,        // 14
  COV_ANGLE_DELTA = 27,   // 7 (delta + 3)
  COV_FILTER_INTRA = 34,  // 5
  COV_PALETTE_Y = 39,     // 7 (size - 2)
  COV_PALETTE_UV = 46,    // 7
  COV_PALETTE_CACHE = 53,
  COV_PALETTE_DELTA_V = 54,
  COV_PARTITION = 55,     // 10
  COV_EDGE_FILTER = 65,   // 3 (strength - 1)
  COV_EDGE_UPSAMPLE = 68,
  COV_GOLOMB = 69,
  COV_SKIP = 70,
  COV_SEGMENT = 71,
  COV_N = 72
};
static int64_t g_cov[COV_N];

struct Params {
  int mi_cols, mi_rows, ssx, ssy, mono, sb128, enable_filter_intra,
      enable_edge_filter, allow_sc, disable_cdf_update, seg_enabled,
      last_active_seg, seg_preskip, seg_skip_mask;
};

struct Decoder {
  Params p;
  uint8_t* planes[3];
  int stride[3];
  int nplanes;
  // per 4x4 unit of the frame
  std::vector<uint8_t> ymode, uvmode, misize, segid, skip, palsz[2];
  std::vector<uint8_t> palcol[2];
  // coefficient contexts of each plane, in that plane's 4x4 units
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3],
      left_dc[3];
  // the tile
  int row_start, row_end, col_start, col_end;
  Msac ms;
  Cdfs cdf;
  uint8_t decoded[3][35][35];  // BlockDecoded, offset by 1
  // the block
  int mi_row, mi_col, mi_size, bw4, bh4, has_chroma;
  bool avail_u, avail_l, avail_u_chroma, avail_l_chroma;
  int blk_skip, segment_id, y_mode, uv_mode, angle_y, angle_uv, cfl_u,
      cfl_v, use_fi, fi_mode, pal_y, pal_uv;
  int max_luma_w, max_luma_h;
  uint8_t pal_colors[3][8];
  uint8_t color_map[2][64 * 64];  // Y, UV; row stride 64
  int error;

  bool inside(int r, int c) const {
    return c >= col_start && c < col_end && r >= row_start && r < row_end;
  }
  int mi(int r, int c) const { return r * p.mi_cols + c; }
  uint8_t& px(int plane, int y, int x) {
    return planes[plane][(size_t)y * stride[plane] + x];
  }

  // -- partition ---------------------------------------------------------
  void decode_partition(int r, int c, int bsize) {
    if (error) return;
    if (r >= p.mi_rows || c >= p.mi_cols) return;
    const bool au = inside(r - 1, c), al = inside(r, c - 1);
    const int num4x4 = NUM_4X4_W[bsize];
    const int half = num4x4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < p.mi_rows;
    const bool has_cols = (c + half) < p.mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      const int bsl = MI_W_LOG2[bsize];
      const int above = au && MI_W_LOG2[misize[mi(r - 1, c)]] < bsl;
      const int left = al && MI_H_LOG2[misize[mi(r, c - 1)]] < bsl;
      const int ctx = left * 2 + above;
      uint16_t* pc = cdf.part[bsl - 1][ctx];
      const int n = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      if (has_rows && has_cols) {
        partition = ms.sym(pc, n);
      } else if (has_cols || has_rows) {
        // the probability of the partitions that split the missing half
        auto p_of = [&](int s) -> unsigned {
          if (s >= n) return 0;
          const unsigned hi = s == 0 ? 32768 : pc[s - 1];
          return hi - pc[s];
        };
        unsigned psum;
        if (has_cols) {
          psum = p_of(PARTITION_VERT) + p_of(PARTITION_SPLIT) +
                 p_of(PARTITION_HORZ_A) + p_of(PARTITION_VERT_A) +
                 p_of(PARTITION_VERT_B);
          if (bsize != BLOCK_128X128) psum += p_of(PARTITION_VERT_4);
        } else {
          psum = p_of(PARTITION_HORZ) + p_of(PARTITION_SPLIT) +
                 p_of(PARTITION_HORZ_A) + p_of(PARTITION_HORZ_B) +
                 p_of(PARTITION_VERT_A);
          if (bsize != BLOCK_128X128) psum += p_of(PARTITION_HORZ_4);
        }
        const int split = ms.boolf(psum);
        partition = split ? PARTITION_SPLIT
                          : has_cols ? PARTITION_HORZ : PARTITION_VERT;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    g_cov[COV_PARTITION + partition]++;
    // dav1d refuses the partitions whose chroma has no block size in 4:2:2
    if (p.ssx && !p.ssy && !p.mono &&
        (partition == PARTITION_VERT || partition == PARTITION_VERT_4 ||
         partition == PARTITION_VERT_A || partition == PARTITION_VERT_B)) {
      error = -3;
      return;
    }
    const int w = NUM_4X4_W[bsize], h = NUM_4X4_H[bsize];
    auto size_of = [](int w4, int h4) -> int {
      for (int b = 0; b < 22; b++)
        if (NUM_4X4_W[b] == w4 && NUM_4X4_H[b] == h4) return b;
      return BLOCK_INVALID;
    };
    const int split = size_of(w / 2 > 0 ? w / 2 : 1, h / 2 > 0 ? h / 2 : 1);
    switch (partition) {
      case PARTITION_NONE:
        decode_block(r, c, bsize);
        break;
      case PARTITION_HORZ:
        decode_block(r, c, size_of(w, h / 2));
        if (has_rows) decode_block(r + half, c, size_of(w, h / 2));
        break;
      case PARTITION_VERT:
        decode_block(r, c, size_of(w / 2, h));
        if (has_cols) decode_block(r, c + half, size_of(w / 2, h));
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, split);
        decode_partition(r, c + half, split);
        decode_partition(r + half, c, split);
        decode_partition(r + half, c + half, split);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, size_of(w, h / 2));
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, size_of(w, h / 2));
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, size_of(w / 2, h));
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, size_of(w / 2, h));
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < p.mi_rows)
            decode_block(r + quarter * i, c, size_of(w, h / 4));
        break;
      default:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < p.mi_cols)
            decode_block(r, c + quarter * i, size_of(w / 4, h));
        break;
    }
  }

  // -- mode info ---------------------------------------------------------
  void read_segment_id() {
    int prev_ul = -1, prev_u = -1, prev_l = -1;
    if (avail_u && avail_l) prev_ul = segid[mi(mi_row - 1, mi_col - 1)];
    if (avail_u) prev_u = segid[mi(mi_row - 1, mi_col)];
    if (avail_l) prev_l = segid[mi(mi_row, mi_col - 1)];
    int pred;
    if (prev_u == -1)
      pred = prev_l == -1 ? 0 : prev_l;
    else if (prev_l == -1)
      pred = prev_u;
    else
      pred = prev_ul == prev_u ? prev_u : prev_l;
    if (blk_skip) {
      segment_id = pred;
      return;
    }
    int ctx;
    if (prev_ul < 0)
      ctx = 0;
    else if (prev_ul == prev_u && prev_ul == prev_l)
      ctx = 2;
    else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l)
      ctx = 1;
    else
      ctx = 0;
    const int diff = ms.sym(cdf.seg[ctx], 8);
    const int max = p.last_active_seg + 1;
    int v;
    if (!pred)
      v = diff;
    else if (pred >= max - 1)
      v = max - diff - 1;
    else if (2 * pred < max)
      v = diff <= 2 * pred ? (diff & 1 ? pred + ((diff + 1) >> 1)
                                       : pred - (diff >> 1))
                           : diff;
    else
      v = diff <= 2 * (max - pred - 1)
              ? (diff & 1 ? pred + ((diff + 1) >> 1) : pred - (diff >> 1))
              : max - (diff + 1);
    segment_id = std::min(std::max(v, 0), p.last_active_seg);
    g_cov[COV_SEGMENT]++;
  }

  int get_palette_cache(int plane, uint8_t* cache) {
    int above_n = 0, left_n = 0;
    if (((mi_row * 4) % 64) && avail_u)
      above_n = palsz[plane][mi(mi_row - 1, mi_col)];
    if (avail_l) left_n = palsz[plane][mi(mi_row, mi_col - 1)];
    const uint8_t* ac = &palcol[plane][(size_t)mi(mi_row - 1, mi_col) * 8];
    const uint8_t* lc = &palcol[plane][(size_t)mi(mi_row, mi_col - 1) * 8];
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
      const int a = ac[ai], l = lc[li];
      if (l < a) {
        if (n == 0 || l != cache[n - 1]) cache[n++] = l;
        li++;
      } else {
        if (n == 0 || a != cache[n - 1]) cache[n++] = a;
        ai++;
        if (l == a) li++;
      }
    }
    for (; ai < above_n; ai++)
      if (n == 0 || ac[ai] != cache[n - 1]) cache[n++] = ac[ai];
    for (; li < left_n; li++)
      if (n == 0 || lc[li] != cache[n - 1]) cache[n++] = lc[li];
    return n;
  }

  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, pw = 2;
    while (pw < x) {
      i++;
      pw <<= 1;
    }
    return i;
  }

  // palette_colors_y / palette_colors_u: cache hits, one literal, deltas
  void read_palette_colors(int plane, int n, uint8_t* colors) {
    uint8_t cache[16];
    const int cache_n = get_palette_cache(plane, cache);
    int idx = 0;
    for (int i = 0; i < cache_n && idx < n; i++)
      if (ms.equi()) {
        colors[idx++] = cache[i];
        g_cov[COV_PALETTE_CACHE]++;
      }
    if (idx < n) colors[idx++] = ms.lit(8);
    int bits = 0;
    if (idx < n) bits = 8 - 3 + ms.lit(2);
    while (idx < n) {
      int delta = ms.lit(bits);
      if (plane == 0) delta++;
      const int v = std::min(colors[idx - 1] + delta, 255);
      colors[idx] = v;
      const int range = 256 - v - (plane == 0 ? 1 : 0);
      idx++;
      bits = std::min(bits, ceil_log2(range));
    }
    std::sort(colors, colors + n);
  }

  void palette_mode_info() {
    const int bsize_ctx = MI_W_LOG2[mi_size] + MI_H_LOG2[mi_size] - 2;
    if (y_mode == DC_PRED) {
      int ctx = 0;
      if (avail_u && palsz[0][mi(mi_row - 1, mi_col)] > 0) ctx++;
      if (avail_l && palsz[0][mi(mi_row, mi_col - 1)] > 0) ctx++;
      if (ms.bool_adapt(cdf.pal_y[bsize_ctx * 3 + ctx])) {
        pal_y = ms.sym(cdf.pal_y_size[bsize_ctx], 7) + 2;
        read_palette_colors(0, pal_y, pal_colors[0]);
        g_cov[COV_PALETTE_Y + pal_y - 2]++;
      }
    }
    if (has_chroma && uv_mode == DC_PRED) {
      if (ms.bool_adapt(cdf.pal_uv[pal_y > 0])) {
        pal_uv = ms.sym(cdf.pal_uv_size[bsize_ctx], 7) + 2;
        read_palette_colors(1, pal_uv, pal_colors[1]);
        uint8_t* v = pal_colors[2];
        if (ms.equi()) {
          g_cov[COV_PALETTE_DELTA_V]++;
          const int bits = 8 - 4 + ms.lit(2);
          v[0] = ms.lit(8);
          for (int i = 1; i < pal_uv; i++) {
            int delta = ms.lit(bits);
            if (delta && ms.equi()) delta = -delta;
            int val = v[i - 1] + delta;
            if (val < 0) val += 256;
            if (val >= 256) val -= 256;
            v[i] = std::min(std::max(val, 0), 255);
          }
        } else {
          for (int i = 0; i < pal_uv; i++) v[i] = ms.lit(8);
        }
        g_cov[COV_PALETTE_UV + pal_uv - 2]++;
      }
    }
  }

  void intra_frame_mode_info() {
    blk_skip = 0;
    segment_id = 0;
    if (p.seg_enabled && p.seg_preskip) read_segment_id();
    if (p.seg_preskip && p.seg_enabled &&
        ((p.seg_skip_mask >> segment_id) & 1)) {
      blk_skip = 1;
    } else {
      int ctx = 0;
      if (avail_u) ctx += skip[mi(mi_row - 1, mi_col)];
      if (avail_l) ctx += skip[mi(mi_row, mi_col - 1)];
      blk_skip = ms.bool_adapt(cdf.skip[ctx]);
    }
    if (blk_skip) g_cov[COV_SKIP]++;
    if (p.seg_enabled && !p.seg_preskip) read_segment_id();
    const int above = avail_u ? ymode[mi(mi_row - 1, mi_col)] : DC_PRED;
    const int left = avail_l ? ymode[mi(mi_row, mi_col - 1)] : DC_PRED;
    y_mode = ms.sym(
        cdf.kf_y[INTRA_MODE_CONTEXT[above] * 5 + INTRA_MODE_CONTEXT[left]], 13);
    angle_y = angle_uv = 0;
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_y = ms.sym(cdf.angle[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    cfl_u = cfl_v = 0;
    if (has_chroma) {
      const bool cfl_allowed =
          SS_SIZE[mi_size][p.ssx][p.ssy] == BLOCK_4X4;  // lossless
      uv_mode = cfl_allowed ? ms.sym(cdf.uv_cfl[y_mode], 14)
                            : ms.sym(cdf.uv_nocfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) {
        const int signs = ms.sym(cdf.cfl_sign, 8);
        const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
          cfl_u = 1 + ms.sym(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
          if (sign_u == 1) cfl_u = -cfl_u;
        }
        if (sign_v) {
          cfl_v = 1 + ms.sym(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
          if (sign_v == 1) cfl_v = -cfl_v;
        }
      }
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_uv = ms.sym(cdf.angle[uv_mode - V_PRED], 7) - 3;
    }
    pal_y = pal_uv = 0;
    if (mi_size >= BLOCK_8X8 && NUM_4X4_W[mi_size] <= 16 &&
        NUM_4X4_H[mi_size] <= 16 && p.allow_sc)
      palette_mode_info();
    use_fi = 0;
    if (p.enable_filter_intra && y_mode == DC_PRED && pal_y == 0 &&
        std::max(NUM_4X4_W[mi_size], NUM_4X4_H[mi_size]) <= 8) {
      use_fi = ms.bool_adapt(cdf.fi[mi_size]);
      if (use_fi) {
        fi_mode = ms.sym(cdf.fi_mode, 5);
        g_cov[COV_FILTER_INTRA + fi_mode]++;
      }
    }
    g_cov[COV_YMODE + y_mode]++;
    if (has_chroma) g_cov[COV_UVMODE + uv_mode]++;
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      g_cov[COV_ANGLE_DELTA + angle_y + 3]++;
  }

  // the colour index map, in wavefront order
  void read_color_map(int plane, int n, int bw, int bh, int onw, int onh) {
    uint8_t* map = color_map[plane ? 1 : 0];
    uint16_t* cdfs = plane ? cdf.pal_uv_color[(n - 2) * 5]
                           : cdf.pal_y_color[(n - 2) * 5];
    // NS(n)
    {
      int w = 0;
      while ((1 << (w + 1)) <= n) w++;
      w += 1;
      const int m = (1 << w) - n;
      int v = ms.lit(w - 1);
      if (v >= m) v = (v << 1) - m + ms.equi();
      map[0] = v;
    }
    for (int i = 1; i < onh + onw - 1; i++) {
      for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
        const int r = i - j, c = j;
        int scores[8] = {0}, order[8];
        for (int k = 0; k < 8; k++) order[k] = k;
        if (c > 0) scores[map[r * 64 + c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[(r - 1) * 64 + c - 1]] += 1;
        if (r > 0) scores[map[(r - 1) * 64 + c]] += 2;
        for (int k = 0; k < 3; k++) {
          int max_score = scores[k], max_idx = k;
          for (int l = k + 1; l < n; l++)
            if (scores[l] > max_score) {
              max_score = scores[l];
              max_idx = l;
            }
          if (max_idx != k) {
            const int ms_ = scores[max_idx], mo = order[max_idx];
            for (int l = max_idx; l > k; l--) {
              scores[l] = scores[l - 1];
              order[l] = order[l - 1];
            }
            scores[k] = ms_;
            order[k] = mo;
          }
        }
        const int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
        const int ctx = PALETTE_COLOR_CONTEXT[hash];
        const int idx = ms.sym(cdfs + (ctx < 0 ? 0 : ctx) * 9, n);
        map[r * 64 + c] = order[idx];
      }
    }
    for (int i = 0; i < onh; i++)
      for (int j = onw; j < bw; j++) map[i * 64 + j] = map[i * 64 + onw - 1];
    for (int i = onh; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i * 64 + j] = map[(onh - 1) * 64 + j];
  }

  void palette_tokens() {
    int bh = NUM_4X4_H[mi_size] * 4, bw = NUM_4X4_W[mi_size] * 4;
    int onh = std::min(bh, (p.mi_rows - mi_row) * 4);
    int onw = std::min(bw, (p.mi_cols - mi_col) * 4);
    if (pal_y) read_color_map(0, pal_y, bw, bh, onw, onh);
    if (pal_uv) {
      bh >>= p.ssy;
      bw >>= p.ssx;
      onh >>= p.ssy;
      onw >>= p.ssx;
      if (bw < 4) {
        bw += 2;
        onw += 2;
      }
      if (bh < 4) {
        bh += 2;
        onh += 2;
      }
      read_color_map(1, pal_uv, bw, bh, onw, onh);
    }
  }

  // -- prediction ----------------------------------------------------------
  bool is_smooth(int r, int c, int plane) {
    const int mode = plane == 0 ? ymode[mi(r, c)] : uvmode[mi(r, c)];
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED ||
           mode == SMOOTH_H_PRED;
  }
  int get_filter_type(int plane) {
    bool a = false, l = false;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (p.ssx && !(mi_col & 1)) c++;
        if (p.ssy && (mi_row & 1)) r--;
      }
      a = is_smooth(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (p.ssx && (mi_col & 1)) c--;
        if (p.ssy && !(mi_row & 1)) r++;
      }
      l = is_smooth(r, c, plane);
    }
    return a || l;
  }
  static int edge_strength(int filter_type, int delta) {
    // w + h == 8: the 4x4 transform blocks of a lossless frame
    const int d = std::abs(delta);
    if (filter_type == 0) return d >= 56 ? 1 : 0;
    return d >= 64 ? 2 : d >= 40 ? 1 : 0;
  }
  static void edge_filter(int* buf, int sz, int strength) {
    // buf[-1 .. sz - 2] in, buf[0 .. sz - 2] filtered
    if (!strength) return;
    int edge[40];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        const int k = std::min(std::max(i - 2 + j, 0), sz - 1);
        s += INTRA_EDGE_KERNEL[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
    g_cov[COV_EDGE_FILTER + strength - 1]++;
  }
  static void edge_upsample(int* buf, int num_px) {
    int dup[40];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = std::min(std::max((s + 8) >> 4, 0), 255);
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
    g_cov[COV_EDGE_UPSAMPLE]++;
  }

  void predict_intra(int plane, int x, int y, bool have_left, bool have_above,
                     bool have_above_rt, bool have_below_lft, int mode) {
    const int w = 4, h = 4;
    const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
    const int max_x = ((p.mi_cols * 4) >> sx) - 1;
    const int max_y = ((p.mi_rows * 4) >> sy) - 1;
    int above_buf[48], left_buf[48];
    int* A = above_buf + 16;
    int* L = left_buf + 16;
    for (int i = 0; i < w + h; i++) {
      if (!have_above && have_left)
        A[i] = px(plane, y, x - 1);
      else if (!have_above && !have_left)
        A[i] = 127;
      else {
        const int limit =
            std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
        A[i] = px(plane, y - 1, std::min(limit, x + i));
      }
      if (!have_left && have_above)
        L[i] = px(plane, y - 1, x);
      else if (!have_left && !have_above)
        L[i] = 129;
      else {
        const int limit =
            std::min(max_y, y + (have_below_lft ? 2 * h : h) - 1);
        L[i] = px(plane, std::min(limit, y + i), x - 1);
      }
    }
    if (have_above && have_left)
      A[-1] = px(plane, y - 1, x - 1);
    else if (have_above)
      A[-1] = px(plane, y - 1, x);
    else if (have_left)
      A[-1] = px(plane, y, x - 1);
    else
      A[-1] = 128;
    L[-1] = A[-1];
    int pred[4][4];
    if (plane == 0 && use_fi) {
      for (int i2 = 0; i2 < 2; i2++) {
        int pv[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0)
              pv[i] = A[i - 1];
            else if (i == 0)
              pv[i] = L[(i2 << 1) - 1];
            else
              pv[i] = pred[(i2 << 1) - 1][i - 1];
          } else {
            pv[i] = L[(i2 << 1) + i - 5];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++)
            pr += INTRA_FILTER_TAPS[fi_mode][i][j] * pv[j];
          const int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
          pred[(i2 << 1) + (i >> 2)][i & 3] = std::min(std::max(v, 0), 255);
        }
      }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      const int delta = plane == 0 ? angle_y : angle_uv;
      const int angle = MODE_TO_ANGLE[mode] + delta * 3;
      int up_above = 0, up_left = 0;
      if (p.enable_edge_filter) {
        if (angle != 90 && angle != 180) {
          const int ft = get_filter_type(plane);
          if (have_above) {
            const int n = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
            edge_filter(A, n, edge_strength(ft, angle - 90));
          }
          if (have_left) {
            const int n = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
            edge_filter(L, n, edge_strength(ft, angle - 180));
          }
        }
        const int da = std::abs(angle - 90), dl = std::abs(angle - 180);
        up_above = da > 0 && da < 40;  // w + h == 8 for either filter type
        up_left = dl > 0 && dl < 40;
        if (up_above) edge_upsample(A, w + (angle < 90 ? h : 0));
        if (up_left) edge_upsample(L, h + (angle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (angle < 90)
        dx = DR_INTRA_DERIVATIVE[angle];
      else if (angle > 90 && angle < 180)
        dx = DR_INTRA_DERIVATIVE[180 - angle];
      if (angle > 90 && angle < 180)
        dy = DR_INTRA_DERIVATIVE[angle - 90];
      else if (angle > 180)
        dy = DR_INTRA_DERIVATIVE[270 - angle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (angle < 90) {
            const int idx = (i + 1) * dx;
            const int base = (idx >> (6 - up_above)) + (j << up_above);
            const int shift = ((idx << up_above) >> 1) & 0x1F;
            const int max_base = (w + h - 1) << up_above;
            if (base < max_base)
              v = (A[base] * (32 - shift) + A[base + 1] * shift + 16) >> 5;
            else
              v = A[max_base];
          } else if (angle > 90 && angle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              const int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              v = (A[base] * (32 - shift) + A[base + 1] * shift + 16) >> 5;
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - up_left);
              const int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
              v = (L[base] * (32 - shift) + L[base + 1] * shift + 16) >> 5;
            }
          } else if (angle > 180) {
            const int idx = (j + 1) * dy;
            const int base = (idx >> (6 - up_left)) + (i << up_left);
            const int shift = ((idx << up_left) >> 1) & 0x1F;
            const int max_base = (w + h - 1) << up_left;
            if (base < max_base)
              v = (L[base] * (32 - shift) + L[base + 1] * shift + 16) >> 5;
            else
              v = L[max_base];
          } else if (angle == 90) {
            v = A[j];
          } else {
            v = L[i];
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          const int s = SM_WEIGHTS_4[i] * A[j] +
                        (256 - SM_WEIGHTS_4[i]) * L[h - 1] +
                        SM_WEIGHTS_4[j] * L[i] +
                        (256 - SM_WEIGHTS_4[j]) * A[w - 1];
          pred[i][j] = (s + 256) >> 9;
        }
    } else if (mode == SMOOTH_V_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (SM_WEIGHTS_4[i] * A[j] +
                        (256 - SM_WEIGHTS_4[i]) * L[h - 1] + 128) >> 8;
    } else if (mode == SMOOTH_H_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (SM_WEIGHTS_4[j] * L[i] +
                        (256 - SM_WEIGHTS_4[j]) * A[w - 1] + 128) >> 8;
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int s = 0;
        for (int k = 0; k < 4; k++) s += A[k] + L[k];
        avg = (s + 4) >> 3;
      } else if (have_left) {
        int s = 0;
        for (int k = 0; k < 4; k++) s += L[k];
        avg = (s + 2) >> 2;
      } else if (have_above) {
        int s = 0;
        for (int k = 0; k < 4; k++) s += A[k];
        avg = (s + 2) >> 2;
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH_PRED
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          const int base = A[j] + L[i] - A[-1];
          const int pl = std::abs(base - L[i]), pt = std::abs(base - A[j]),
                    ptl = std::abs(base - A[-1]);
          pred[i][j] = (pl <= pt && pl <= ptl) ? L[i] : pt <= ptl ? A[j] : A[-1];
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) px(plane, y + i, x + j) = pred[i][j];
  }

  void predict_cfl(int plane, int sx0, int sy0) {
    const int alpha = plane == 1 ? cfl_u : cfl_v;
    int lum[4][4], sum = 0;
    for (int i = 0; i < 4; i++) {
      int ly = (sy0 + i) << p.ssy;
      ly = std::min(ly, max_luma_h - (1 << p.ssy));
      for (int j = 0; j < 4; j++) {
        int lx = (sx0 + j) << p.ssx;
        lx = std::min(lx, max_luma_w - (1 << p.ssx));
        int t = 0;
        for (int dy = 0; dy <= p.ssy; dy++)
          for (int dx = 0; dx <= p.ssx; dx++) t += px(0, ly + dy, lx + dx);
        const int v = t << (3 - p.ssx - p.ssy);
        lum[i][j] = v;
        sum += v;
      }
    }
    const int avg = (sum + 8) >> 4;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        const int dc = px(plane, sy0 + i, sx0 + j);
        const int s = alpha * (lum[i][j] - avg);
        const int scaled = s >= 0 ? (s + 32) >> 6 : -((-s + 32) >> 6);
        px(plane, sy0 + i, sx0 + j) = std::min(std::max(dc + scaled, 0), 255);
      }
  }

  // -- coefficients and the inverse Walsh-Hadamard transform ---------------
  int coeffs(int plane, int x4, int y4, int* quant) {
    const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
    const int max_x4 = p.mi_cols >> sx, max_y4 = p.mi_rows >> sy;
    uint8_t* al = &above_level[plane][x4];
    uint8_t* ad = &above_dc[plane][x4];
    uint8_t* ll = &left_level[plane][y4 & 31];
    uint8_t* ld = &left_dc[plane][y4 & 31];
    const int ptype = plane > 0;
    int ctx;
    if (plane == 0) {
      int top = x4 < max_x4 ? *al : 0, left = y4 < max_y4 ? *ll : 0;
      if (mi_size == BLOCK_4X4)
        ctx = 0;
      else if (top == 0 && left == 0)
        ctx = 1;
      else if (top == 0 || left == 0)
        ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3)
        ctx = 4;
      else if (std::min(top, left) <= 3)
        ctx = 5;
      else
        ctx = 6;
    } else {
      const int above = x4 < max_x4 ? (*al | *ad) : 0;
      const int left = y4 < max_y4 ? (*ll | *ld) : 0;
      ctx = 7 + (above != 0) + (left != 0);
      if (SS_SIZE[mi_size][p.ssx][p.ssy] != BLOCK_4X4) ctx += 3;
    }
    for (int i = 0; i < 16; i++) quant[i] = 0;
    int eob = 0, cul_level = 0, dc_category = 0;
    if (!ms.bool_adapt(cdf.txb_skip[ctx])) {
      const int eob_pt = ms.sym(cdf.eob16[ptype * 2], 5) + 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (ms.bool_adapt(cdf.eob_extra[ptype * 9 + eob_pt - 3]))
          eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          shift = std::max(0, eob_pt - 2) - 1 - i;
          if (ms.equi()) eob += 1 << shift;
        }
      }
      for (int c = eob - 1; c >= 0; c--) {
        const int pos = DEFAULT_SCAN_4X4[c];
        int level;
        if (c == eob - 1) {
          const int ectx = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
          level = ms.sym(cdf.base_eob[ptype * 4 + ectx], 3) + 1;
        } else {
          const int row = pos >> 2, col = pos & 3;
          int mag = 0;
          static const int8_t off[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2},
                                           {2, 0}};
          for (int k = 0; k < 5; k++) {
            const int rr = row + off[k][0], cc = col + off[k][1];
            if (rr < 4 && cc < 4) mag += std::min(std::abs(quant[rr * 4 + cc]), 3);
          }
          int bctx = std::min((mag + 1) >> 1, 4);
          if (pos == 0)
            bctx = 0;
          else
            bctx += COEFF_BASE_CTX_OFFSET_4X4[std::min(row, 4)][std::min(col, 4)];
          level = ms.sym(cdf.base[ptype * 42 + bctx], 4);
        }
        if (level > 2) {
          const int row = pos >> 2, col = pos & 3;
          int mag = 0;
          static const int8_t off[3][2] = {{0, 1}, {1, 0}, {1, 1}};
          for (int k = 0; k < 3; k++) {
            const int rr = row + off[k][0], cc = col + off[k][1];
            if (rr < 4 && cc < 4) mag += std::min(quant[rr * 4 + cc], 15);
          }
          mag = std::min((mag + 1) >> 1, 6);
          const int bctx = pos == 0 ? mag : (row < 2 && col < 2) ? mag + 7
                                                                 : mag + 14;
          for (int idx = 0; idx < 4; idx++) {
            const int br = ms.sym(cdf.br[ptype * 21 + bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        const int pos = DEFAULT_SCAN_4X4[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dsign = 0;
            if (x4 < max_x4) dsign += *ad == 1 ? -1 : *ad == 2 ? 1 : 0;
            if (y4 < max_y4) dsign += *ld == 1 ? -1 : *ld == 2 ? 1 : 0;
            const int dctx = dsign < 0 ? 1 : dsign > 0 ? 2 : 0;
            sign = ms.bool_adapt(cdf.dc_sign[ptype * 3 + dctx]);
          } else {
            sign = ms.equi();
          }
        }
        unsigned tok = quant[pos];
        if (tok > 14) {
          tok = (ms.golomb() + 15) & 0xfffff;
          g_cov[COV_GOLOMB]++;
        }
        if (pos == 0 && tok > 0) dc_category = sign ? 1 : 2;
        cul_level += tok;
        // dequantised with the lossless quantiser (4), clamped as dav1d does
        const int mag = (int)std::min<unsigned>(tok * 4u, 32767u + sign);
        quant[pos] = sign ? -mag : mag;
      }
      cul_level = std::min(63, cul_level);
    }
    *al = cul_level;
    *ad = dc_category;
    *ll = cul_level;
    *ld = dc_category;
    return eob;
  }

  static void wht_1d(int* t, int stride, int shift) {
    int a = t[0] >> shift, c = t[stride] >> shift, d = t[2 * stride] >> shift,
        b = t[3 * stride] >> shift;
    a += c;
    d -= b;
    const int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    t[0] = a;
    t[stride] = b;
    t[2 * stride] = c;
    t[3 * stride] = d;
  }

  void reconstruct(int plane, int x, int y, int* q) {
    for (int i = 0; i < 4; i++) wht_1d(q + 4 * i, 1, 2);
    for (int j = 0; j < 4; j++) wht_1d(q + j, 4, 0);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        uint8_t& d = px(plane, y + i, x + j);
        d = std::min(std::max(d + q[i * 4 + j], 0), 255);
      }
  }

  void transform_block(int plane, int base_x, int base_y, int x, int y) {
    const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
    const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    const int sb_mask = p.sb128 ? 31 : 15;
    const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    const int sbr = (row & sb_mask) >> sy, sbc = (col & sb_mask) >> sx;
    const int max_x = (p.mi_cols * 4) >> sx, max_y = (p.mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    if ((plane == 0 && pal_y) || (plane != 0 && pal_uv)) {
      const uint8_t* map = color_map[plane ? 1 : 0];
      const uint8_t* pal = pal_colors[plane];
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
          px(plane, start_y + i, start_x + j) =
              pal[map[(y * 4 + i) * 64 + x * 4 + j]];
    } else {
      const bool is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
      const int mode = plane == 0 ? y_mode : is_cfl ? DC_PRED : uv_mode;
      predict_intra(plane, start_x, start_y,
                    (plane == 0 ? avail_l : avail_l_chroma) || x > 0,
                    (plane == 0 ? avail_u : avail_u_chroma) || y > 0,
                    decoded[plane][sbr - 1 + 1][sbc + 1 + 1],
                    decoded[plane][sbr + 1 + 1][sbc - 1 + 1], mode);
      if (is_cfl) predict_cfl(plane, start_x, start_y);
    }
    if (plane == 0) {
      max_luma_w = start_x + 4;
      max_luma_h = start_y + 4;
    }
    if (!blk_skip) {
      int q[16];
      if (coeffs(plane, start_x >> 2, start_y >> 2, q) > 0)
        reconstruct(plane, start_x, start_y, q);
    }
    decoded[plane][sbr + 1][sbc + 1] = 1;
  }

  void residual() {
    const int wc = std::max(1, NUM_4X4_W[mi_size] >> 4);
    const int hc = std::max(1, NUM_4X4_H[mi_size] >> 4);
    for (int cy = 0; cy < hc; cy++)
      for (int cx = 0; cx < wc; cx++)
        for (int plane = 0; plane < 1 + has_chroma * 2; plane++) {
          const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
          const int psz = plane ? SS_SIZE[mi_size][p.ssx][p.ssy] : mi_size;
          const int n4w = NUM_4X4_W[psz], n4h = NUM_4X4_H[psz];
          const int bx = (mi_col >> sx) * 4, by = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> sy); y++)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x++)
              transform_block(plane, bx, by, x + ((cx << 4) >> sx),
                              y + ((cy << 4) >> sy));
        }
  }

  void reset_block_context() {
    for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
      const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++)
        above_level[plane][i] = above_dc[plane][i] = 0;
      for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++)
        left_level[plane][i & 31] = left_dc[plane][i & 31] = 0;
    }
  }

  void decode_block(int r, int c, int bsize) {
    if (error) return;
    if (bsize == BLOCK_INVALID || SS_SIZE[bsize][p.ssx][p.ssy] == BLOCK_INVALID) {
      error = -3;
      return;
    }
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    bw4 = NUM_4X4_W[bsize];
    bh4 = NUM_4X4_H[bsize];
    if (p.mono)
      has_chroma = 0;
    else if (bh4 == 1 && p.ssy && (mi_row & 1) == 0)
      has_chroma = 0;
    else if (bw4 == 1 && p.ssx && (mi_col & 1) == 0)
      has_chroma = 0;
    else
      has_chroma = 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (p.ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (p.ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = false;
    }
    intra_frame_mode_info();
    palette_tokens();
    if (blk_skip) reset_block_context();
    for (int y = 0; y < bh4 && r + y < p.mi_rows; y++)
      for (int x = 0; x < bw4 && c + x < p.mi_cols; x++) {
        const int k = mi(r + y, c + x);
        ymode[k] = y_mode;
        if (has_chroma) uvmode[k] = uv_mode;
        skip[k] = blk_skip;
        misize[k] = mi_size;
        segid[k] = segment_id;
        palsz[0][k] = pal_y;
        palsz[1][k] = pal_uv;
        memcpy(&palcol[0][(size_t)k * 8], pal_colors[0], 8);
        memcpy(&palcol[1][(size_t)k * 8], pal_colors[1], 8);
      }
    residual();
    // dav1d refuses a tile whose symbol decoder has consumed more than 14
    // bits past its data (the specification's bound on SymbolMaxBits)
    if (ms.cnt < -14) error = -4;
  }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int plane = 0; plane < nplanes; plane++) {
      const int sx = plane ? p.ssx : 0, sy = plane ? p.ssy : 0;
      const int sbw4 = (col_end - c) >> sx, sbh4 = (row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4)
            v = 1;
          else if (x < 0 && y < sbh4)
            v = 1;
          else
            v = 0;
          decoded[plane][y + 1][x + 1] = v;
        }
      decoded[plane][(sb4 >> sy) + 1][0] = 0;
    }
  }

  void decode_tile(const uint8_t* data, size_t size) {
    init_cdfs(cdf);
    ms.init(data, size, p.disable_cdf_update);
    for (int plane = 0; plane < nplanes; plane++) {
      std::fill(above_level[plane].begin(), above_level[plane].end(), 0);
      std::fill(above_dc[plane].begin(), above_dc[plane].end(), 0);
    }
    const int sb4 = p.sb128 ? 32 : 16;
    const int sb_size = p.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = row_start; r < row_end && !error; r += sb4) {
      for (int plane = 0; plane < nplanes; plane++) {
        std::fill(left_level[plane].begin(), left_level[plane].end(), 0);
        std::fill(left_dc[plane].begin(), left_dc[plane].end(), 0);
      }
      for (int c = col_start; c < col_end && !error; c += sb4) {
        clear_block_decoded(r, c, sb4);
        decode_partition(r, c, sb_size);
      }
    }
  }
};

}  // namespace

extern "C" {

// Decodes the tiles of one lossless AV1 intra frame into its planes.
// p: mi_cols, mi_rows, ssx, ssy, mono, sb128, enable_filter_intra,
// enable_intra_edge_filter, allow_screen_content_tools,
// disable_cdf_update, segmentation_enabled, last_active_seg_id,
// seg_id_pre_skip, the mask of segments with SEG_LVL_SKIP, tile_cols,
// tile_rows, then MiColStarts[tile_cols + 1], MiRowStarts[tile_rows + 1].
// tiles: (offset, size) of each tile's data in `data`, in raster order.
// Planes are (mi_rows * 4 >> ss) rows of (mi_cols * 4 >> ss) bytes.
// Returns 0, or a negative code where dav1d refuses the frame.
int64_t vt_av1_decode_frame(const uint8_t* data, int64_t len,
                            const int64_t* tiles, const int32_t* prm,
                            uint8_t* y, uint8_t* u, uint8_t* v) {
  Decoder* d = new Decoder();
  Params& p = d->p;
  p.mi_cols = prm[0];
  p.mi_rows = prm[1];
  p.ssx = prm[2];
  p.ssy = prm[3];
  p.mono = prm[4];
  p.sb128 = prm[5];
  p.enable_filter_intra = prm[6];
  p.enable_edge_filter = prm[7];
  p.allow_sc = prm[8];
  p.disable_cdf_update = prm[9];
  p.seg_enabled = prm[10];
  p.last_active_seg = prm[11];
  p.seg_preskip = prm[12];
  p.seg_skip_mask = prm[13];
  const int tile_cols = prm[14], tile_rows = prm[15];
  const int32_t* col_starts = prm + 16;
  const int32_t* row_starts = col_starts + tile_cols + 1;
  d->nplanes = p.mono ? 1 : 3;
  d->planes[0] = y;
  d->planes[1] = u;
  d->planes[2] = v;
  d->stride[0] = p.mi_cols * 4;
  d->stride[1] = d->stride[2] = (p.mi_cols * 4) >> p.ssx;
  const size_t n = (size_t)p.mi_cols * p.mi_rows;
  d->ymode.assign(n, 0);
  d->uvmode.assign(n, 0);
  d->misize.assign(n, 0);
  d->segid.assign(n, 0);
  d->skip.assign(n, 0);
  for (int k = 0; k < 2; k++) {
    d->palsz[k].assign(n, 0);
    d->palcol[k].assign(n * 8, 0);
  }
  for (int k = 0; k < 3; k++) {
    d->above_level[k].assign(p.mi_cols + 32, 0);
    d->above_dc[k].assign(p.mi_cols + 32, 0);
    d->left_level[k].assign(32, 0);
    d->left_dc[k].assign(32, 0);
  }
  d->error = 0;
  for (int tr = 0; tr < tile_rows && !d->error; tr++)
    for (int tc = 0; tc < tile_cols && !d->error; tc++) {
      const int t = tr * tile_cols + tc;
      const int64_t off = tiles[2 * t], size = tiles[2 * t + 1];
      if (off < 0 || size < 0 || off + size > len) {
        d->error = -2;
        break;
      }
      d->row_start = row_starts[tr];
      d->row_end = row_starts[tr + 1];
      d->col_start = col_starts[tc];
      d->col_end = col_starts[tc + 1];
      d->decode_tile(data + off, (size_t)size);
    }
  const int64_t err = d->error;
  delete d;
  return err;
}

void vt_av1_coverage(int64_t* out, int32_t reset) {
  for (int i = 0; i < COV_N; i++) out[i] = g_cov[i];
  if (reset) memset(g_cov, 0, sizeof g_cov);
}

}  // extern "C"
